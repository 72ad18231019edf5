"""The SSD chunked scan's gradient where a chunk's decay passes f32's
range (``models.ssm._ssd_chunked``), held against the recurrence it
computes, on the CPU.

Within a chunk the scan weighs position ``j``'s input at position ``i``
by ``exp(cum_i - cum_j)``; above the diagonal that exponent is positive
and, once ``dt * |a|`` summed over a chunk passes about 88, its exp is
infinite. The JAX package (``repro.models.ssm._ssd_chunked``) masks the
exp after taking it: its forward is finite, but its gradient multiplies
the masked zeros by the infinite exp, and every gradient of ``dt``,
``a``, ``B``, ``C`` and ``x`` turns NaN (a full-width jamba's backward
showed it on the card). The port masks the exponent first: its forward
equals the JAX package's, and its gradient equals that of the
token-by-token recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T``,
``y_t = C_t h_t``, taken in f64. Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.models import ssm as TS

B, S, H, P, N, CHUNK = 2, 32, 3, 4, 5, 16
# the gradients against the f64 recurrence: each within this share of its
# largest |value| (f32 products and sums in another order; measured
# 6.7e-8-4.4e-7). a's sums terms weighted by decays of up to 380 that
# cancel: measured 5.5e-4 in f32, while the chunked form in f64 equals the
# recurrence within 5.3e-12
GRAD_TOL = {"a": 1e-3}
GRAD_TOL_DEFAULT = 1e-5


def _inputs(seed=0):
    """(xh, dt, a, bmat, cmat, ct): dt near 8 and a of -1..-3, so that a
    chunk of 16 positions decays by 130-380 (exp overflows past 88)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, H, P)).astype(np.float32),
            rng.uniform(6, 10, (B, S, H)).astype(np.float32),
            -np.array([1.0, 2.0, 3.0], np.float32),
            rng.normal(0, 1, (B, S, N)).astype(np.float32),
            rng.normal(0, 1, (B, S, N)).astype(np.float32),
            rng.normal(0, 1, (B, S, H, P)).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
          for a in arrays[:5]]
    y, state = TS._ssd_chunked(*ts, chunk=CHUNK)
    (y * torch.tensor(arrays[5], dtype=dtype)).sum().backward()
    return y.detach(), state.detach(), [t.grad for t in ts]


def _recurrence(arrays):
    """The scan token by token in f64: its output and gradients."""
    xh, dt, a, bmat, cmat = [torch.tensor(v, dtype=torch.float64,
                                          requires_grad=True)
                             for v in arrays[:5]]
    h = torch.zeros((B, H, N, P), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * a)[..., None, None] * h \
            + (dt[:, t, :, None, None] * bmat[:, t, None, :, None]
               * xh[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", cmat[:, t], h))
    y = torch.stack(ys, 1)
    (y * torch.tensor(arrays[5], dtype=torch.float64)).sum().backward()
    return y.detach(), [t.grad for t in (xh, dt, a, bmat, cmat)]


def test_the_decay_overflows_f32_within_a_chunk():
    _, dt, a, *_ = _inputs()
    span = (dt.reshape(B, S // CHUNK, CHUNK, H) * -a).sum(2)
    assert span.min() > 89.0


def test_forward_equals_repro():
    arrays = _inputs()
    y, state, _ = _port(arrays)
    yj, sj = RS._ssd_chunked(*[jnp.asarray(v) for v in arrays[:5]],
                             chunk=CHUNK)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("which", ["xh", "dt", "a", "bmat", "cmat"])
def test_gradient_is_finite_and_equals_the_recurrence(which):
    arrays = _inputs()
    y, _, grads = _port(arrays)
    y_ref, ref = _recurrence(arrays)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4,
                               atol=1e-4 * float(y_ref.abs().max()))
    i = ["xh", "dt", "a", "bmat", "cmat"].index(which)
    got, exp = grads[i], ref[i]
    assert torch.isfinite(got).all()
    tol = GRAD_TOL.get(which, GRAD_TOL_DEFAULT)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=0,
                               atol=tol * float(exp.abs().max()))


def test_repro_gradient_is_nan_where_the_port_is_finite():
    arrays = _inputs()

    def loss(*args):
        y, _ = RS._ssd_chunked(*args, chunk=CHUNK)
        return jnp.sum(y * jnp.asarray(arrays[5]))

    gj = jax.grad(loss, argnums=(1, 2))(*[jnp.asarray(v)
                                          for v in arrays[:5]])
    assert all(np.isnan(np.asarray(g)).any() for g in gj)
    _, _, grads = _port(arrays)
    assert all(torch.isfinite(g).all() for g in grads)
