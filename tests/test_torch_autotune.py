"""The port's launch autotuner (``repro_torch.kernels.autotune``) on the CPU:
its resolution order, loud validation, override grammar, table, candidate
star and key, against the JAX package's ``kernels/autotune.py`` where the
two share a design, and the config as part of the program key."""
import dataclasses
import json

import numpy as np
import pytest

from repro.kernels import autotune as RA
from repro_torch.core import api
from repro_torch.core.api import ParallelDecoder
from repro_torch.kernels import autotune as AT

from _torch_corpus import corpus, oracle_coeffs


class Shape:
    """A stand-in bucket: the tuner keys on ``label()`` only."""

    def __init__(self, label):
        self._label = label

    def label(self):
        return self._label


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "launch.json"
    monkeypatch.setenv(AT.TABLE_ENV, str(path))
    monkeypatch.delenv(AT.LAUNCH_ENV, raising=False)
    monkeypatch.delenv(AT.AUTOTUNE_ENV, raising=False)
    AT.clear_launch_cache()
    yield path
    AT.clear_launch_cache()


def counting(winner=None):
    """A fake measure: 1 s for every config, 0.5 s for ``winner``."""
    calls = []

    def measure(cfg):
        calls.append(cfg)
        return 0.5 if cfg == winner else 1.0
    return measure, calls


def never(cfg):
    raise AssertionError("measured")


# -- resolution order ------------------------------------------------------------

def test_defaults_are_the_kernels_constants():
    d = AT.DEFAULT_LAUNCH
    assert (d.exit_threads, d.stream_threads, d.store_threads,
            d.store_writer, d.pixel_groups, d.idct_groups,
            d.block_rounds) == (256, 1024, 256, "auto", 0, 0, 4)
    from repro_torch.core.sync import BLOCK_ROUNDS
    assert d.block_rounds == BLOCK_ROUNDS


def test_override_wins_over_everything(table, monkeypatch):
    monkeypatch.setenv(AT.LAUNCH_ENV, "exit=128, writer=lane")
    want = dataclasses.replace(AT.DEFAULT_LAUNCH, exit_threads=128,
                               store_writer="lane")
    assert AT.resolve_launch(Shape("b"), "cuda", "post", measure=never,
                             kind="k") == want
    # also on the plain backend
    assert AT.resolve_launch(Shape("b"), "torch", "none", kind="k") == want


def test_plain_backend_gets_defaults_and_never_measures(table):
    assert AT.resolve_launch(Shape("b"), "torch", "none", measure=never,
                             kind="k") == AT.DEFAULT_LAUNCH
    assert not table.exists()


def test_measure_then_memory_then_table(table):
    win = dataclasses.replace(AT.DEFAULT_LAUNCH, stream_threads=512)
    measure, calls = counting(win)
    got = AT.resolve_launch(Shape("b"), "cuda", "post", measure=measure,
                            kind="k")
    assert got == win
    assert len(calls) == 3 * len(AT.candidate_configs())  # 3 in turns
    # memory: no measure, no table read needed
    assert AT.resolve_launch(Shape("b"), "cuda", "post", measure=never,
                             kind="k") == win
    # table: a new process (memory cleared) reads the row
    AT.clear_launch_cache()
    assert AT.resolve_launch(Shape("b"), "cuda", "post", measure=never,
                             kind="k") == win
    row = json.loads(table.read_text())[AT.tune_key(Shape("b"), "cuda",
                                                    "post", "k")]
    assert row == dataclasses.asdict(win)


def test_no_measure_gives_defaults(table):
    assert AT.resolve_launch(Shape("b"), "cuda", "post",
                             kind="k") == AT.DEFAULT_LAUNCH
    assert not table.exists()


def test_table_row_wins_over_measure(table):
    key = AT.tune_key(Shape("b"), "cuda", "full", "k")
    row = dataclasses.asdict(dataclasses.replace(AT.DEFAULT_LAUNCH,
                                                 store_threads=128))
    table.write_text(json.dumps({key: row}))
    got = AT.resolve_launch(Shape("b"), "cuda", "full", measure=never,
                            kind="k")
    assert got.store_threads == 128


@pytest.mark.parametrize("row", [
    {"exit_threads": 300}, {"store_writer": "both"}, {"bogus": 1},
    {"block_rounds": 0}, "not a row"])
def test_corrupt_row_falls_through(table, row):
    key = AT.tune_key(Shape("b"), "cuda", "post", "k")
    table.write_text(json.dumps({key: row}))
    assert AT.resolve_launch(Shape("b"), "cuda", "post",
                             kind="k") == AT.DEFAULT_LAUNCH
    measure, calls = counting()
    AT.clear_launch_cache()
    AT.resolve_launch(Shape("b"), "cuda", "post", measure=measure, kind="k")
    assert calls  # the stale row was re-tuned


def test_table_write_is_an_atomic_merge(table):
    for label in ("a", "b"):
        AT.resolve_launch(Shape(label), "cuda", "post",
                          measure=counting()[0], kind="k")
    data = json.loads(table.read_text())
    assert sorted(data) == sorted(AT.tune_key(Shape(s), "cuda", "post", "k")
                                  for s in ("a", "b"))
    # no temporary file is left beside the table
    assert [p.name for p in table.parent.iterdir()] == [table.name]


# -- the search: the default stays within noise -------------------------------

def test_search_keeps_the_default_within_the_spread():
    # in turns: default, other; the other's median 0.94 beats the
    # default's 1.05 by less than the default's spread 0.2
    times = iter([1.0, 0.95, 1.2, 0.9, 1.05, 0.94])
    cands = AT.candidate_configs()[:2]
    best, seen = AT.search(lambda c: next(times), rounds=3, candidates=cands)
    assert best == cands[0]
    assert len(seen[cands[1]]) == 3


def test_search_drops_refused_candidates():
    cands = AT.candidate_configs()

    def measure(cfg):
        if cfg.store_writer == "warp":
            raise ValueError("fewer lanes than a warp")
        return 0.1 if cfg.exit_threads == 512 else 1.0

    best, seen = AT.search(measure, rounds=3, candidates=cands)
    assert best.exit_threads == 512
    assert all(c.store_writer != "warp" for c in seen)


# -- validation and grammar -----------------------------------------------------

@pytest.mark.parametrize("name,value", [
    ("exit_threads", 300), ("exit_threads", 1024), ("stream_threads", 128),
    ("store_threads", 512), ("store_threads", True), ("store_writer", "x"),
    ("pixel_groups", 6), ("pixel_groups", 52), ("idct_groups", -4),
    ("block_rounds", 0), ("block_rounds", 2.0), ("bogus", 1)])
def test_check_launch_refuses_junk(name, value):
    with pytest.raises(ValueError):
        AT.check_launch(name, value)


@pytest.mark.parametrize("text", [
    "exit", "exits=128", "exit=abc", "exit=300", "writer=4",
    "pixels=7", "rounds=-1"])
def test_override_grammar_refuses_junk(text):
    with pytest.raises(ValueError) as e:
        AT.parse_launch_override(text)
    key = text.partition("=")[0]
    msg = str(e.value)
    assert AT.LAUNCH_ENV in msg or AT._FIELD_ALIASES[key] in msg


def test_override_grammar():
    cfg = AT.parse_launch_override(
        "exit=512,stream=256, store=128,writer=warp,pixels=24,idct=12,"
        "rounds=8,")
    assert cfg == AT.LaunchConfig(512, 256, 128, "warp", 24, 12, 8)
    assert AT.parse_launch_override("") == AT.DEFAULT_LAUNCH


def test_candidate_star():
    cands = AT.candidate_configs()
    assert cands[0] == AT.DEFAULT_LAUNCH
    assert len(cands) == len(set(cands)) == 1 + sum(
        len(v) - 1 for v in AT.LAUNCH_CANDIDATES.values())
    base = dataclasses.asdict(AT.DEFAULT_LAUNCH)
    for c in cands[1:]:
        diff = [k for k, v in dataclasses.asdict(c).items() if v != base[k]]
        assert len(diff) == 1
        AT.check_launch(diff[0], getattr(c, diff[0]))


def test_tune_key():
    key = AT.tune_key(Shape("b1:w2"), "cuda", "post", "NVIDIA-H100")
    assert key == "b1:w2|cuda|post|NVIDIA-H100"
    assert AT.tune_key("s", "cuda", "full", None).endswith("|unknown")


def test_same_fake_measure_picks_the_same_knob_as_the_jax_package(
        tmp_path, monkeypatch):
    """Both tuners measure their star with one fake measure that favours
    the first knob's first candidate; both pick that knob and write their
    table."""
    ref_table, port_table = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setenv(RA.TABLE_ENV, str(ref_table))
    monkeypatch.delenv(RA.TILES_ENV, raising=False)
    monkeypatch.setenv(AT.TABLE_ENV, str(port_table))
    monkeypatch.delenv(AT.LAUNCH_ENV, raising=False)
    RA.clear_tile_cache()
    AT.clear_launch_cache()

    def first_knob_first_value(cfg, candidates):
        name = next(iter(candidates))
        return 0.5 if getattr(cfg, name) == candidates[name][0] else 1.0

    ref = RA.autotune_tiles(Shape("b"), "pallas", "post", kind="k",
                            measure=lambda c: first_knob_first_value(
                                c, RA.TILE_CANDIDATES))
    port = AT.resolve_launch(Shape("b"), "cuda", "post", kind="k",
                             measure=lambda c: first_knob_first_value(
                                 c, AT.LAUNCH_CANDIDATES))

    def changed(cfg, default):
        return [k for k, v in dataclasses.asdict(cfg).items()
                if v != dataclasses.asdict(default)[k]]

    assert changed(ref, RA.DEFAULT_TILES) == [next(iter(RA.TILE_CANDIDATES))]
    assert changed(port, AT.DEFAULT_LAUNCH) == [
        next(iter(AT.LAUNCH_CANDIDATES))]
    assert len(json.loads(ref_table.read_text())) == 1
    assert len(json.loads(port_table.read_text())) == 1
    RA.clear_tile_cache()
    AT.clear_launch_cache()


# -- the config in the program key ---------------------------------------------

def test_two_configs_two_programs_equal_outputs():
    api.clear_decode_programs()
    blobs = corpus("restart")
    other = dataclasses.replace(AT.DEFAULT_LAUNCH, block_rounds=2)
    outs = []
    for cfg in (AT.DEFAULT_LAUNCH, other):
        dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu",
                                         launch=cfg)
        assert dec.launch == cfg and dec.program.launch == cfg
        outs.append(dec.coefficients())
    stats = api.decode_program_stats()
    assert stats["programs"] == 2
    assert {b["launch"]["block_rounds"] for b in stats["buckets"]} == {2, 4}
    exp = oracle_coeffs(blobs)
    for out in outs:
        np.testing.assert_array_equal(out.coeffs.numpy(), exp)
    assert outs[0].sync_rounds == outs[1].sync_rounds
    api.clear_decode_programs()


def test_decoder_resolves_the_override(monkeypatch):
    monkeypatch.setenv(AT.LAUNCH_ENV, "rounds=8")
    AT.clear_launch_cache()
    api.clear_decode_programs()
    dec = ParallelDecoder.from_bytes(corpus("420"), device="cpu")
    assert dec.launch.block_rounds == 8
    np.testing.assert_array_equal(dec.coefficients().coeffs.numpy(),
                                  oracle_coeffs(corpus("420")))
    api.clear_decode_programs()
