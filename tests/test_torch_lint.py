"""The port's linter (``repro_torch.analysis.lint``) against the JAX
package's, and its torch-form rules, on the CPU.

The two rules that read no traced code (swallowed-format-error,
host-divergence) must give the JAX package's findings, rule, line and
column, on its own test snippets. The four that read traced code in JAX
read captured code in the port (a ``torch.cuda.graph`` block, a sync loop
body); each gets cases that fire and cases that stay clean. Then the
suppression grammar, the text-keyed baseline, ``src/repro_torch`` clean
under the port's baseline, and the CLI.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as RL
from repro_torch.analysis import lint as L
from repro_torch.analysis.lint import (apply_baseline, lint_paths,
                                       load_baseline)

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "src" / "repro_torch" / "analysis" / "baseline.txt"


def lint(src: str):
    return L.lint_source(textwrap.dedent(src), "repro_torch/snippet.py")


def rules_of(findings):
    return [f.rule for f in findings]


# -- the two rules shared with the JAX package: equal findings ---------------

# the JAX package's own snippets (tests/test_analysis.py, TestHostDivergence
# and TestSwallowedFormatError), each with the rules it expects
REFERENCE_SNIPPETS = {
    "rendezvous_under_identity_branch": ("""
        import jax

        def init():
            if jax.process_index() == 0:
                jax.distributed.initialize()
    """, ["host-divergence"]),
    "early_return_before_rendezvous": ("""
        def launch(client, rank):
            if rank != 0:
                return None
            client.barrier("ready")
    """, ["host-divergence"]),
    "identity_branch_after_rendezvous": ("""
        def launch(client, rank):
            client.barrier("ready")
            if rank == 0:
                print("all hosts ready")
    """, []),
    "broad_except": ("""
        def parse(blob):
            try:
                return risky(blob)
            except Exception:
                return None
    """, ["swallowed-format-error"]),
    "bare_except": ("""
        def parse(blob):
            try:
                return risky(blob)
            except:
                return None
    """, ["swallowed-format-error"]),
    "reraise": ("""
        def parse(blob):
            try:
                return risky(blob)
            except Exception:
                cleanup()
                raise
    """, []),
    "validator": ("""
        def validate_header(blob):
            try:
                parse(blob)
            except Exception:
                return False
            return True
    """, []),
    "narrow_except": ("""
        def parse(blob):
            try:
                return risky(blob)
            except (KeyError, ValueError):
                return None
    """, []),
}

_SHARED_RULES = ("swallowed-format-error", "host-divergence")


@pytest.mark.parametrize("name", sorted(REFERENCE_SNIPPETS))
def test_shared_rules_match_the_jax_package(name):
    src, want = REFERENCE_SNIPPETS[name]
    src = textwrap.dedent(src)

    def keyed(findings):
        return [(f.rule, f.line, f.col) for f in findings
                if f.rule in _SHARED_RULES]

    ours = keyed(L.lint_source(src, "repro_torch/snippet.py"))
    theirs = keyed(RL.lint_source(src, "repro/snippet.py"))
    assert ours == theirs
    assert [r for r, _, _ in ours] == want


def test_store_ops_under_an_identity_branch_fire():
    fs = lint("""
        def publish(store, process_id, n):
            if process_id == 0:
                store.set("count", str(n))
            store.wait(["count"])
    """)
    assert rules_of(fs) == ["host-divergence"]


def test_init_distributed_after_identity_raise_fires():
    fs = lint("""
        def join(rank, world):
            if rank >= world:
                raise ValueError("bad rank")
            init_distributed(num_processes=world, process_id=rank)
    """)
    assert rules_of(fs) == ["host-divergence"]


def test_uniform_branch_around_rendezvous_clean():
    fs = lint("""
        def join(store, num_processes):
            if num_processes > 1:
                store.set("ready", "1")
    """)
    assert fs == []


# -- traced-host-sync: captured code -------------------------------------------

class TestTracedHostSync:
    def test_item_in_a_loop_body_fires(self):
        fs = lint("""
            def run(blocks, done, count):
                def body():
                    if done.item():
                        return
                    count.add_(1)
                blocks.loop("rounds", body, lambda: (count, ~done), 8)
        """)
        assert rules_of(fs) == ["traced-host-sync"]

    def test_cpu_inside_graph_capture_fires(self):
        fs = lint("""
            import torch

            def capture(g, x):
                with torch.cuda.graph(g):
                    y = x * 2
                    n = y.sum().cpu()
                return n
        """)
        assert rules_of(fs) == ["traced-host-sync"]

    def test_bool_of_tensor_in_graph_pairs_body_fires(self):
        fs = lint("""
            def go(st, bufs, blocks, key, done):
                def body():
                    if bool(done):
                        st["x"] = None
                return _graph_pairs(body, st, bufs, blocks, key)
        """)
        assert rules_of(fs) == ["traced-host-sync"]

    def test_tolist_outside_capture_clean(self):
        fs = lint("""
            def read(done, count):
                return [done.item(), count.tolist()]
        """)
        assert fs == []

    def test_constant_cast_in_captured_code_clean(self):
        fs = lint("""
            import torch

            def capture(g, xs):
                with torch.cuda.graph(g):
                    n = int(len(xs) * 2)
                return n
        """)
        assert fs == []


# -- unsafe-scatter-set: overwrite scatters ------------------------------------

class TestUnsafeScatterSet:
    def test_index_put_with_computed_index_fires(self):
        fs = lint("""
            def place(out, tgt, val):
                return out.index_put_((tgt,), val)
        """)
        assert rules_of(fs) == ["unsafe-scatter-set"]

    def test_scatter_and_index_copy_fire(self):
        fs = lint("""
            def place(out, idx, src):
                out.scatter_(0, idx, src)
                return out.index_copy(0, idx, src)
        """)
        assert rules_of(fs) == ["unsafe-scatter-set"] * 2

    def test_accumulating_forms_clean(self):
        fs = lint("""
            def place(out, tgt, idx, val):
                out.index_put_((tgt,), val, accumulate=True)
                out.scatter_(0, idx, val, reduce="add")
                out.scatter_add_(0, idx, val)
                return out.index_add_(0, idx, val)
        """)
        assert fs == []

    def test_static_index_clean(self):
        fs = lint("""
            def place(out, val):
                return out.index_put_((0,), val)
        """)
        assert fs == []

    def test_verified_module_exempt(self):
        src = textwrap.dedent("""
            def place(out, tgt, val):
                return out.index_put_((tgt,), val)
        """)
        assert L.lint_source(src, "repro_torch/kernels/huffman/ops.py") == []


# -- f64-literal-promotion ------------------------------------------------------

class TestF64Promotion:
    def test_torch_dtype_kwarg_fires(self):
        fs = lint("""
            import torch

            def zeros(n):
                return torch.zeros(n, dtype=torch.float64)
        """)
        assert rules_of(fs) == ["f64-literal-promotion"]

    def test_double_and_to_fire(self):
        fs = lint("""
            import torch

            def widen(x):
                return x.double() + x.to(torch.double)
        """)
        assert rules_of(fs) == ["f64-literal-promotion"] * 2

    def test_host_numpy_f64_clean(self):
        fs = lint("""
            import numpy as np

            def reference(n):
                return np.zeros(n, dtype=np.float64)
        """)
        assert fs == []

    def test_f32_clean(self):
        fs = lint("""
            import torch

            def zeros(n, x):
                return torch.zeros(n, dtype=torch.float32) + x.to(torch.int32)
        """)
        assert fs == []


# -- unhashable-static ------------------------------------------------------------

class TestUnhashableStatic:
    def test_tensor_field_on_frozen_dataclass_fires(self):
        fs = lint("""
            import dataclasses
            import torch

            @dataclasses.dataclass(frozen=True)
            class Key:
                n: int
                table: torch.Tensor
        """)
        assert rules_of(fs) == ["unhashable-static"]

    def test_list_field_fires(self):
        fs = lint("""
            import dataclasses
            from typing import List, Optional

            @dataclasses.dataclass(frozen=True)
            class LaunchKey:
                sizes: Optional[List[int]] = None
        """)
        assert rules_of(fs) == ["unhashable-static"]

    def test_eq_false_identity_hash_clean(self):
        fs = lint("""
            import dataclasses
            import torch

            @dataclasses.dataclass(frozen=True, eq=False)
            class Handle:
                table: torch.Tensor
        """)
        assert fs == []

    def test_scalar_fields_clean(self):
        fs = lint("""
            import dataclasses
            from typing import Tuple

            @dataclasses.dataclass(frozen=True)
            class LaunchConfig:
                exit_threads: int = 256
                store_writer: str = "auto"
                comp_h: Tuple[int, ...] = (2, 1, 1)
        """)
        assert fs == []


# -- suppression and the baseline ------------------------------------------------

BAD_EXCEPT = """
    def parse(blob):
        try:
            return risky(blob)
        except Exception:{allow}
            return None
"""


class TestSuppression:
    def test_inline_allow_suppresses(self):
        assert lint(BAD_EXCEPT.format(
            allow="  # repro: allow[swallowed-format-error]")) == []

    def test_allow_on_line_above_suppresses(self):
        assert lint("""
            def parse(blob):
                try:
                    return risky(blob)
                # a justified catch-all  # repro: allow[swallowed-format-error]
                except Exception:
                    return None
        """) == []

    def test_allow_for_other_rule_does_not_suppress(self):
        fs = lint(BAD_EXCEPT.format(allow="  # repro: allow[traced-host-sync]"))
        assert rules_of(fs) == ["swallowed-format-error"]

    def test_allow_list_suppresses(self):
        assert lint(BAD_EXCEPT.format(
            allow="  # repro: allow[traced-host-sync, swallowed-format-error]"
        )) == []


class TestBaseline:
    def test_baselined_finding_filtered(self, tmp_path):
        fs = lint(BAD_EXCEPT.format(allow=""))
        assert len(fs) == 1
        bl = tmp_path / "baseline.txt"
        bl.write_text("# comment\n" + fs[0].baseline_key() + " :: known\n")
        new, stale = apply_baseline(fs, load_baseline(bl))
        assert new == [] and stale == []

    def test_stale_entry_reported(self, tmp_path):
        bl = tmp_path / "baseline.txt"
        bl.write_text("swallowed-format-error :: repro_torch/gone.py :: "
                      "except Exception: :: old\n")
        new, stale = apply_baseline([], load_baseline(bl))
        assert new == [] and len(stale) == 1

    def test_key_survives_line_drift(self):
        fs1 = lint(BAD_EXCEPT.format(allow=""))
        fs2 = lint("\n\n# moved down\n"
                   + textwrap.dedent(BAD_EXCEPT.format(allow="")))
        assert fs1[0].line != fs2[0].line
        assert fs1[0].baseline_key() == fs2[0].baseline_key()


def test_port_is_lint_clean_under_its_baseline():
    findings = lint_paths([ROOT / "src" / "repro_torch"], root=ROOT / "src")
    new, stale = apply_baseline(findings, load_baseline(BASELINE))
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == []
    # every accepted finding carries a justification
    assert all(v.strip() for v in load_baseline(BASELINE).values())


def test_lint_cli_exits_zero():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "lint", "--baseline"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 findings (after baseline)" in r.stdout
