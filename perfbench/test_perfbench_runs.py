"""Whole runs of a tiny cell on the CPU, each in a process of its own:
the result line's keys, the traced run's readings, and a cell and a
metric added as files only."""
import json

from perfbench.tiny_cell import CELL, make_root, rehearse, write

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
ARGS = ("--workload", CELL, "--seed", "3000000007", "--seconds", "0.5")


def test_a_sound_run_is_correct_and_prints_the_contracts_keys(tmp_path):
    rc, last, err = rehearse(make_root(tmp_path), *ARGS, "--trace", "0")
    assert rc == 0, err
    assert list(last) == CONTRACT + ["checks"]
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0 and last["attempted"] % 4 == 0
    assert set(last["metrics"]) == {"images_per_s", "batch_ms_p95",
                                    "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in last["metrics"].values())
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(last["checks"]) == {"rgb_max_diff", "rgb_off_share",
                                   "unconverged_batches"}
    tail = err.strip().splitlines()[-3:]
    assert all(line.startswith("check ") and "limit" in line
               for line in tail)


def test_frames_of_another_grain_are_made_apart_and_checked(tmp_path):
    root = make_root(tmp_path)
    rc, last, err = rehearse(root, *ARGS, "--trace", "0", grain=5)
    assert rc == 0, err
    assert last["correct"] is True
    rc, last, err = rehearse(root, *ARGS, "--trace", "0")
    assert rc == 0, err
    assert len(list((root / "perfbench/.cache").iterdir())) == 2


def test_a_traced_run_reads_the_programs_counters(tmp_path):
    rc, last, err = rehearse(make_root(tmp_path), *ARGS, "--trace", "1")
    assert rc == 0, err
    assert last["correct"] is True
    # the CPU has no device trace: only the program's counters are read
    assert set(last["metrics"]) == {"sync_rounds", "launches_per_batch"}
    assert last["metrics"]["sync_rounds"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(last["device"])
    assert list(last)[-1] == "checks"
    assert all(len(v) <= 10 for v in last["breakdown"].values())


def test_a_cell_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.t4r", "config": "tiny",
                               "traffic": "t4r", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "batches_seen", "unit": "batches",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.t4r"]})
    write(root / "BENCHMARK.json", bench)
    t4 = json.loads((root / "perfbench/workloads/t4.json").read_text())
    write(root / "perfbench/workloads/t4r.json",
          dict(t4, restart_interval=1))
    (root / "perfbench/metrics/batches_seen.py").write_text(
        "def read(run):\n    return len(run.batch_s)\n")
    rc, last, err = rehearse(root, "--workload", "tiny.t4r", *ARGS[2:],
                             "--trace", "0")
    assert rc == 0, err
    assert last["correct"] is True
    assert last["metrics"]["batches_seen"]["value"] == \
        last["attempted"] // 4
