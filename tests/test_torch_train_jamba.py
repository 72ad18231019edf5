"""jamba's ``forward_train`` loss and gradients in bf16 against the JAX
package run op by op (``jax.disable_jit``; see
``test_torch_train_eager.py``), on the CPU, at smoke size. Measured:
19.1% over all leaves (worst leaf 21%, an SSD ``a_log``: its top-2 of 4
experts meets routing near-ties, ``test_torch_ssm.py``), the loss within
6.2e-4; held at ``BF16_GLOBAL_ROUTED``."""
from _torch_lm import BF16_GLOBAL_ROUTED, check_bf16


def test_jamba_loss_and_gradients_match_repro_op_by_op_in_bf16():
    check_bf16("jamba-v0.1-52b", eager=True, global_tol=BF16_GLOBAL_ROUTED)
