"""``flash_attention`` at the dense LM's own layout.

The dense LM computes q/k/v as ``[B, L, H, Dh]`` and hands
``ops.flash_attention`` their ``[B, H, L, Dh]`` transposed views; the
card's bfloat16 kernel reads those strides in place.  On the CPU, with
inputs made by numpy from a seed:

* the dispatch on strided views equals its result on contiguous copies
  bit for bit (float32 and bfloat16, causal and not, Lq < Lk), and both
  match the reference's Pallas kernel in interpret mode at the tolerances
  of ``test_torch_lm.py`` (float32 1e-5; bfloat16 8e-3);
* the wrapper refuses, before any device work, a bfloat16 view the
  tensor maps cannot describe (last stride not 1, a stride or base off 16
  bytes), and makes float32 views contiguous instead of refusing them;
* the bfloat16 gate (``flash_attention.bf16_error_bound``) holds the
  kernel's arithmetic (p rounded to bfloat16 before P V) against the twin
  and rejects a mask that is one column off;
* the per-route launch counters reset with the others;
* causal operands with ``Lq > Lk`` (whose first rows would see no key)
  raise ``ValueError`` from ``ops.flash_attention`` before dispatch.

On a card (marked ``cuda``): the tensor-core route against the twin at the
bfloat16 gate on strided operands, Dh 64, 128 and 160 (stablelm-12b's
heads: two 64-column boxes and a third padded by TMA), without a float32-route
launch; causal ``Lq > Lk`` raises there too, launching nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}

CASES = [  # b, hq, hkv, lq, lk, dh, causal
    (1, 3, 1, 128, 128, 64, True),      # GQA 3:1, the forward's shape
    (2, 6, 2, 128, 128, 16, False),
    (1, 3, 1, 64, 192, 32, True),       # Lq < Lk: causal offset Lk - Lq
]


def _blhd(b, hq, hkv, lq, lk, dh, seed=7):
    """Seeded q ``[B, Lq, Hq, Dh]`` and k/v ``[B, Lk, Hkv, Dh]`` (numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_strided_views_equal_contiguous(case, dtype):
    """The model's transposed views and contiguous copies of them give the
    same bits, and both follow the Pallas kernel (interpret mode)."""
    b, hq, hkv, lq, lk, dh, causal = case
    tdt, jdt = _DT[dtype]
    arrays = _blhd(b, hq, hkv, lq, lk, dh)
    views = [torch.from_numpy(a).to(tdt).transpose(1, 2) for a in arrays]
    assert not views[0].is_contiguous()
    copies = [t.contiguous() for t in views]
    got = ops.flash_attention(*views, causal=causal)
    assert torch.equal(got, ops.flash_attention(*copies, causal=causal))
    pallas = flash_attention_pallas(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jdt) for a in arrays),
        causal=causal, block_q=64, block_k=64)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)


def _bad_layouts():
    """bfloat16 ``[1, 2, 64, 64]`` operands TMA cannot read, by fault."""
    bf = torch.bfloat16
    last = torch.zeros(1, 2, 64, 128, dtype=bf)[..., ::2]
    odd = torch.zeros(1, 64, 2, 68, dtype=bf)[..., :64].transpose(1, 2)
    shifted = torch.zeros(2 * 64 * 64 + 1, dtype=bf)[1:].view(1, 2, 64, 64)
    return {"last stride": (last, "stride 1"),
            "row stride": (odd, "multiples of 16 bytes"),
            "base": (shifted, "16-byte boundary")}


@pytest.mark.parametrize("operand", [0, 1, 2])
@pytest.mark.parametrize("fault", ["last stride", "row stride", "base"])
def test_wrapper_refuses_layouts_tma_cannot_read(fault, operand):
    """A bad bf16 view of q, k or v raises its layout error before the
    wrapper looks for a card (these tensors lie on the CPU)."""
    bad, message = _bad_layouts()[fault]
    assert bad.shape == (1, 2, 64, 64)
    good = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    operands = [good, good, good]
    operands[operand] = bad
    with pytest.raises(ValueError, match=message):
        flash_mod.flash_attention_cuda(*operands)


def test_wrapper_takes_float32_views_as_copies():
    """Float32 operands are made contiguous, not refused for their layout:
    the same views reach the device check."""
    bad = torch.zeros(1, 2, 64, 128)[..., ::2]
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_mod.flash_attention_cuda(bad, bad, bad)


def _p_rounded(q, k, v, causal, shift=0):
    """The tensor-core route's arithmetic in plain torch: float32 logits
    scaled after the dot, masked to -1e30 (``shift`` moves the causal
    diagonal), the denominator from the unrounded p, p rounded to bfloat16
    before P V, one division and one rounding."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    s = q.float() @ kf.transpose(-1, -2) * (1.0 / dh ** 0.5)
    if causal:
        rows = torch.arange(lq)[:, None] + (lk - lq) + shift
        s = torch.where(rows >= torch.arange(lk)[None, :], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return ((p.to(torch.bfloat16).float() @ vf) / den).to(q.dtype)


@pytest.mark.parametrize("case", CASES)
def test_bf16_gate_holds_p_rounding_and_rejects_a_shifted_mask(case):
    """The gate covers rounding p to bf16 (which moves the outputs) and
    still catches a causal mask one column off."""
    b, hq, hkv, lq, lk, dh, causal = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
               for a in _blhd(b, hq, hkv, lq, lk, dh, seed=11))
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    bound = flash_mod.bf16_error_bound(q, k, v, want, causal=causal)
    assert bound.dtype == torch.float32 and bound.shape == want.shape
    got = _p_rounded(q, k, v, causal)
    assert not torch.equal(got, want)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    if causal:
        off = _p_rounded(q, k, v, causal, shift=1)
        assert not bool(((off.float() - want.float()).abs() <= bound).all())


def test_route_counters_reset_with_the_others():
    """``reset_launch_counts`` zeroes flash's per-route counters too, and
    ``flash_route_counts`` hands out a copy."""
    routes = flash_mod.flash_attention_cuda.routes
    assert set(routes) == {"tensor_core", "float32"}
    routes["tensor_core"] += 3
    snapshot = ops.flash_route_counts()
    snapshot["float32"] += 1
    assert ops.flash_route_counts()["float32"] == routes["float32"]
    ops.reset_launch_counts()
    assert ops.flash_route_counts() == {"tensor_core": 0, "float32": 0}
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_lq_above_lk_raises(dtype):
    """Causal Lq > Lk raises ValueError on the CPU (the twin would average
    every v for the rows that see no key); the same shapes without the
    mask, and causal Lq <= Lk, still run."""
    tdt = _DT[dtype][0]
    q, k, v = (torch.from_numpy(a).to(tdt).transpose(1, 2)
               for a in _blhd(1, 3, 1, 128, 64, 16))
    with pytest.raises(ValueError, match="Lq <= Lk"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention(q, k, v, causal=False).shape == q.shape
    assert ops.flash_attention(k, q[:, :1], q[:, :1],
                               causal=True).shape == k.shape


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 160])
def test_tensor_core_route_on_card(cuda, dh):
    """bf16 views of [B, L, H, Dh] tensors (query and key tiles cut by Lq
    and Lk) through the tensor-core route only, within the bf16 gate; the
    result is the view of a contiguous [B, Lq, Hq, Dh] tensor."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16).transpose(1, 2)
               for a in _blhd(2, 6, 2, 192, 320, dh))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_route_counts() == {"tensor_core": 1, "float32": 0}
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    want = ref.flash_attention_ref(q, k, v, causal=True)
    bound = flash_mod.bf16_error_bound(q, k, v, want, causal=True)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_lq_above_lk_raises_on_card(cuda, dtype):
    """Causal Lq > Lk raises ValueError on the card too, before any
    launch, on either route."""
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               .transpose(1, 2) for a in _blhd(1, 6, 2, 256, 128, 64))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="Lq <= Lk"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_route_counts() == {"tensor_core": 0, "float32": 0}
