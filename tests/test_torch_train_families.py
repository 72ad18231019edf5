"""``forward_train``'s loss and every gradient in f32 against the JAX
package's for the MoE, MLA, SSD and encoder-decoder archs, on the CPU,
at smoke size, at the tolerances of ``test_torch_train.py`` (the MoE
buffer fill and the SSD's in-place products carry their gradients)."""
import pytest

from _torch_lm import check_f32

FAMILIES = ["deepseek-v2-236b", "deepseek-v3-671b", "mamba2-780m",
            "jamba-v0.1-52b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_repro_in_f32(arch):
    check_f32(arch)
