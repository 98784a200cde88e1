"""The port's flash attention (kernel B9) against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  JAX runs
``flash_attention`` in Pallas interpret mode on the CPU and its dense oracle
``flash_attention_ref``; the port runs the plain version of its CUDA kernel
(a CPU tensor never reaches the kernel).  Tolerances are
``tests/test_flash_kernel.py``'s: 2e-5 in float32 on unit-normal inputs
(float32 sums in another order), 3e-2 in bfloat16.  The ``gpu`` tests hold
the CUDA kernel to its plain version on the card and skip without one; they
need no JAX (where it is absent, run them with ``pytest --noconftest -m
gpu``).
"""

import importlib.util

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


def test_plain_version_is_the_dense_twin():
    q, k, v = _torch(_qkv(5, 2, 3, 48, 24, skv=48))
    for causal in (True, False):
        assert torch.equal(
            t_flash.flash_attention_plain(q, k, v, causal=causal),
            t_ref.flash_attention_ref(q, k, v, causal=causal))


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


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 64, 128, 256])
def test_flash_kernel_matches_plain_on_card(cuda_device, hd):
    """B9 against its plain version on the same card inputs: S in {32, 96
    (block 32), 1024}, causal and not, float32 at 2e-5 and bfloat16 at
    3e-2; one launch per call."""
    for s, blk in ((32, 128), (96, 32), (1024, 128)):
        arrays = _qkv(s + hd, 2, 3, s, hd)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            q, k, v = _torch(arrays, dtype, cuda_device)
            for causal in (True, False):
                before = t_flash.LAUNCHES["flash_attn_fwd"]
                got = t_flash.flash_attention(q, k, v, causal=causal, bq=blk,
                                              bk=blk)
                torch.cuda.synchronize()
                assert t_flash.LAUNCHES["flash_attn_fwd"] == before + 1
                want = t_flash.flash_attention_plain(q, k, v, causal=causal)
                assert got.dtype == dtype
                err = float((got.float() - want.float()).abs().max())
                assert err <= tol, (s, dtype, causal, err)


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
    with pytest.raises(ValueError, match="contiguous"):
        t_flash.launch(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2))
