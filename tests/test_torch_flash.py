"""The port's flash attention (kernel B9) against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  JAX runs
``flash_attention`` in Pallas interpret mode on the CPU and its dense oracle
``flash_attention_ref``; the port runs the plain version of its CUDA kernel
(a CPU tensor never reaches the kernel).  Tolerances are
``tests/test_flash_kernel.py``'s: 2e-5 in float32 on unit-normal inputs
(float32 sums in another order), 3e-2 in bfloat16.  The wrapper's stride
and layout checks run here too.  The ``gpu`` tests hold the CUDA kernel to
its plain version on the card (bfloat16 also each element within one bf16
step plus 2e-5) and skip without one; they need no JAX (where it is
absent, run them with ``pytest --noconftest -m gpu``).
"""

import importlib.util
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

if importlib.util.find_spec("jax") is None:
    jax = None  # the card's machine runs the gpu tests without JAX
else:  # with JAX present, a broken reference package fails the run
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.kernels.ref import flash_attention_ref as j_flash_ref

    jax.config.update("jax_platform_name", "cpu")

needs_jax = pytest.mark.skipif(jax is None,
                               reason="needs the JAX reference package")

F32_TOL, BF16_TOL = 2e-5, 3e-2


def _qkv(seed, b, h, s, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, h, s, hd)).astype(np.float32),
            rng.normal(size=(b, h, skv, hd)).astype(np.float32),
            rng.normal(size=(b, h, skv, hd)).astype(np.float32))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _jax(arrays, dtype=None):
    return [jnp.asarray(a, dtype) for a in arrays]


@needs_jax
@pytest.mark.parametrize("s,hd,bq,bk,causal", [
    (64, 32, 16, 16, True), (128, 64, 32, 32, True), (128, 64, 64, 32, True),
    (64, 32, 16, 32, False), (96, 8, 32, 32, True), (32, 128, 128, 128, False),
])
def test_flash_matches_jax_kernel_and_oracle_f32(s, hd, bq, bk, causal):
    arrays = _qkv(s + hd, 2, 2, s, hd)
    want = np.asarray(j_flash(*_jax(arrays), causal=causal, bq=bq, bk=bk))
    oracle = np.asarray(j_flash_ref(*_jax(arrays), causal=causal))
    got = t_flash.flash_attention(*_torch(arrays), causal=causal, bq=bq,
                                  bk=bk).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)
    np.testing.assert_allclose(got, oracle, atol=F32_TOL)


@needs_jax
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_bf16(causal):
    arrays = _qkv(1, 1, 2, 64, 32)
    want = j_flash(*_jax(arrays, jnp.bfloat16), causal=causal, bq=16, bk=16)
    got = t_flash.flash_attention(*_torch(arrays, torch.bfloat16),
                                  causal=causal, bq=16, bk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_TOL)


@needs_jax
def test_flash_rejects_bad_blocks_as_jax():
    arrays = _qkv(3, 1, 1, 96, 32)
    with pytest.raises(ValueError):
        j_flash(*_jax(arrays), bq=64, bk=64)  # 96 % 64 != 0
    with pytest.raises(ValueError, match="must divide blocks"):
        t_flash.flash_attention(*_torch(arrays), bq=64, bk=64)


def test_flash_causality():
    """Future keys must not influence earlier queries: changing the last
    key and value leaves every earlier row bit-identical."""
    q, k, v = _torch(_qkv(2, 1, 1, 64, 32))
    out1 = t_flash.flash_attention(q, k, v, causal=True, bq=16, bk=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] = 99.0
    v2[:, :, -1] = -99.0
    out2 = t_flash.flash_attention(q, k2, v2, causal=True, bq=16, bk=16)
    assert torch.equal(out1[:, :, :-1], out2[:, :, :-1])
    assert not torch.equal(out1[:, :, -1], out2[:, :, -1])


def test_flash_checks_inputs():
    q, k, v = _torch(_qkv(4, 1, 2, 32, 16))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        t_flash.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="head dim"):
        t_flash.flash_attention(*_torch(_qkv(4, 1, 1, 32, 257)))
    with pytest.raises(ValueError, match="must be"):
        t_flash.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.launch(q, k, v)  # the kernel itself never takes CPU tensors
    empty = torch.zeros(0, 2, 0, 16)
    assert t_flash.flash_attention(empty, empty, empty).shape == (0, 2, 0, 16)


def _offset_view(t):
    """``t`` as a view one element into a tensor one column wider: its
    pointer and row strides are not 16-byte aligned, so the kernel takes its
    per-element loads and stores whatever hd is."""
    wide = torch.zeros(*t.shape[:3], t.shape[3] + 1, dtype=t.dtype,
                       device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def test_kernel_strides_take_transposed_views():
    """The kernel takes [B, S, H, hd] tensors seen as [B, H, S, hd] through
    ``transpose(1, 2)`` by their strides, the output in q's layout, and
    refuses a last dim that is not contiguous."""
    b, s, h, hd = 2, 40, 3, 16
    q, k, v = (t.transpose(1, 2) for t in
               _torch(_qkv(7, b, s, h, hd)))  # [B, H, S, hd] views
    o = torch.empty_like(q)  # what the kernel's wrapper allocates
    assert o.stride() == q.stride() and o.transpose(1, 2).is_contiguous()
    bshd = [s * h * hd, hd, h * hd]
    assert t_flash.kernel_strides(q, k, v, o) == bshd * 4
    assert t_flash.kernel_strides(*[t.contiguous() for t in (q, k, v, o)]) \
        == [h * s * hd, s * hd, hd] * 4
    with pytest.raises(ValueError, match="last dim of k must be contiguous"):
        t_flash.kernel_strides(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v, o)
    hd1 = torch.zeros(b, h, 1, s).transpose(2, 3)  # hd 1: any last stride
    assert len(t_flash.kernel_strides(hd1, hd1, hd1, hd1)) == 12


def test_flash_strided_inputs_equal_contiguous():
    q, k, v = (t.transpose(1, 2) for t in _torch(_qkv(8, 2, 48, 4, 32)))
    for causal in (True, False):
        want = t_flash.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal, bq=16,
                                       bk=16)
        for view in ((q, k, v), [_offset_view(t) for t in (q, k, v)]):
            got = t_flash.flash_attention(*view, causal=causal, bq=16, bk=16)
            assert torch.equal(got, want)


def test_plain_version_is_the_dense_twin():
    q, k, v = _torch(_qkv(5, 2, 3, 48, 24, skv=48))
    for causal in (True, False):
        assert torch.equal(
            t_flash.flash_attention_plain(q, k, v, causal=causal),
            t_ref.flash_attention_ref(q, k, v, causal=causal))


def test_plain_version_takes_a_score_scale():
    """``scale`` multiplies the scores (Granite 4.0's attention_multiplier);
    0 keeps 1/sqrt(hd)."""
    q, k, v = _torch(_qkv(7, 1, 2, 40, 16))
    q = q * 8
    for causal in (True, False):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 128
        if causal:
            s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1),
                              -1e30)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
        got = t_flash.flash_attention(q, k, v, causal=causal, bq=8, bk=8,
                                      scale=1 / 128)
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=0)
        assert float((got - t_flash.flash_attention(
            q, k, v, causal=causal, bq=8, bk=8)).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash attention kernel has no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, want):
    """Each element within one bfloat16 step of ``want`` plus the float32
    bound: both sides round float32 results that agree to that bound."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= want.abs() * 2.0**-7 + F32_TOL).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 12, 16, 32, 64, 80, 128, 160, 256])
def test_flash_kernel_matches_plain_on_card(cuda_device, hd):
    """B9 against its plain version on the same card inputs: S in {32, 96
    (block 32), 1024}, causal and not, contiguous [B, H, S, hd], the
    transposed views of [B, S, H, hd] tensors and unaligned views, float32
    at 2e-5 and bfloat16 at 3e-2 and one bf16 step per element; one launch
    per call.  hd 12 and the unaligned views take the per-element path, hd
    80 and 160 the hd-96 and hd-192 tiles."""
    for s, blk in ((32, 128), (96, 32), (1024, 128)):
        arrays = _qkv(s + hd, 2, 3, s, hd)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dense = _torch(arrays, dtype, cuda_device)
            layouts = {
                "dense": dense,
                "strided": [t.transpose(1, 2).contiguous().transpose(1, 2)
                            for t in dense],
                "offset": [_offset_view(t) for t in dense]}
            for (layout, (q, k, v)), causal in itertools.product(
                    layouts.items(), (True, False)):
                before = t_flash.LAUNCHES["flash_attn_fwd"]
                got = t_flash.flash_attention(q, k, v, causal=causal, bq=blk,
                                              bk=blk)
                torch.cuda.synchronize()
                assert t_flash.LAUNCHES["flash_attn_fwd"] == before + 1
                want = t_flash.flash_attention_plain(q, k, v, causal=causal)
                assert got.dtype == dtype and got.stride() == (
                    dense[0].stride() if layout == "offset" else q.stride())
                err = float((got.float() - want.float()).abs().max())
                assert err <= tol, (s, dtype, layout, causal, err)
                assert dtype == torch.float32 or _bf16_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [96, 1024])
def test_flash_kernel_takes_its_callers_scale_on_card(cuda_device, s):
    """B9 with Granite 4.0's score scale, 1/128 at hd 128, against its plain
    version at the same scale, float32 and bfloat16, causal and not; q 16
    times wider than k so that the scores spread and the default scale's
    output lies far away."""
    arrays = _qkv(s, 2, 4, s, 128)
    arrays = (arrays[0] * 16,) + arrays[1:]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v = _torch(arrays, dtype, cuda_device)
        for causal in (True, False):
            before = t_flash.LAUNCHES["flash_attn_fwd"]
            got = t_flash.flash_attention(q, k, v, causal=causal, bq=32,
                                          bk=32, scale=1 / 128)
            torch.cuda.synchronize()
            assert t_flash.LAUNCHES["flash_attn_fwd"] == before + 1
            want = t_flash.flash_attention_plain(q, k, v, causal=causal,
                                                 scale=1 / 128)
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol, (dtype, causal, err)
            assert dtype == torch.float32 or _bf16_close(got, want)
            unscaled = t_flash.flash_attention_plain(q, k, v, causal=causal)
            assert float((got.float() - unscaled.float()).abs().max()) \
                > 10 * BF16_TOL


@pytest.mark.gpu
def test_flash_kernel_causality_and_empty_on_card(cuda_device):
    q, k, v = _torch(_qkv(6, 1, 2, 200, 64), device=cuda_device)
    out1 = t_flash.launch(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] = 99.0
    v2[:, :, -1] = -99.0
    out2 = t_flash.launch(q, k2, v2, causal=True)
    assert torch.equal(out1[:, :, :-1], out2[:, :, :-1])
    before = t_flash.LAUNCHES["flash_attn_fwd"]
    empty = torch.zeros(0, 2, 64, 64, device=cuda_device)
    assert t_flash.launch(empty, empty, empty).shape == (0, 2, 64, 64)
    assert t_flash.LAUNCHES["flash_attn_fwd"] == before
    # a strided layout is taken as it is; a strided last dim is refused
    tq, tk, tv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert torch.equal(t_flash.launch(tq, tk, tv, causal=True), out1)
    with pytest.raises(ValueError, match="contiguous"):
        t_flash.launch(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
