"""deepseek-v3's ``forward_train`` loss (with its MTP loss) and gradients
in bf16 against the JAX package run op by op (``jax.disable_jit``; see
``test_torch_train_eager.py``), on the CPU, at smoke size. Measured:
17.9% over all leaves (worst leaf 28%, an MLA norm behind MoE routing
near-ties that a last bit flips, in the stack and in the MTP head), the
loss within 7.2e-4; held at ``BF16_GLOBAL_ROUTED``."""
from _torch_lm import BF16_GLOBAL_ROUTED, check_bf16


def test_deepseek_v3_loss_and_gradients_match_repro_op_by_op_in_bf16():
    check_bf16("deepseek-v3-671b", eager=True,
               global_tol=BF16_GLOBAL_ROUTED)
