"""``forward_train``'s loss and gradients in bf16 for whisper against the
JAX package run op by op (``jax.disable_jit``), on the CPU, at smoke size
(deepseek-v3 and jamba: ``test_torch_train_deepseek_v3.py``,
``test_torch_train_jamba.py``, a file each for time).

Compiled, the reference fuses bf16 steps inside its scan over periods
and its MTP head (ROADMAP C: jamba's compiled and op-by-op forwards
differ by 1.77, whisper's by 0.19), and its gradients then differ from
the port's by 74% (deepseek-v3), 90% (whisper) and 98% (jamba) over all
leaves. Op by op, measured: whisper 1.2% over all leaves (worst leaf
1.9%), the loss within 2e-7; deepseek-v3 17.9% (worst leaf 28%, the
MLA norms behind MoE routing near-ties that a last bit flips, in the
stack and in the MTP head), the loss within 7.2e-4. Held as
``test_torch_train_bf16.py`` holds the others; deepseek-v3 and jamba
within ``_torch_lm.BF16_GLOBAL_ROUTED`` (0.3) over all leaves.
"""
from _torch_lm import check_bf16


def test_whisper_loss_and_gradients_match_repro_op_by_op_in_bf16():
    check_bf16("whisper-base", eager=True)
