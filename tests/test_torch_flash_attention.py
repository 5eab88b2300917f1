"""The port's flash-attention contract vs the JAX package's Pallas kernel.

``flash_attention_plain`` — what the wrapper runs on CPU tensors, and what
the CUDA kernel ``csrc/flash_attention.cu`` is held against on the card —
through ``repro_torch.kernels.ops.flash_attn`` against
``repro.kernels.ops.flash_attn`` (the Pallas kernel in interpret mode) on
the same numpy inputs: float32 at atol = rtol = 1e-5 (the same f32
arithmetic, blocks folded in another order), bfloat16 at 5e-2 (the JAX
test's own bf16 tolerance: the two frameworks round the 16-bit output of
slightly different f32 sums), float16 at atol 4e-3 (two f16 ulps of
|o| ~ 2-4).  Any head dim 1..256 is taken.  The causal mask is top-left, as the Pallas kernel's;
``ref.flash_attention_ref`` (bottom-right) is compared at Sq == Sk only.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monoids as jm
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import flash_attention_plain, ops
from repro_torch.kernels.flash_attention import LIBRARY, flash_attention

# the JAX package's kernel test shapes (tests/test_kernels.py)
JAX_SHAPES = [
    (1, 2, 2, 128, 32, 64, 64),     # MHA
    (2, 4, 2, 128, 64, 128, 64),    # GQA 2:1
    (1, 8, 2, 256, 64, 64, 128),    # GQA 4:1, rectangular blocks
]


def _qkv(seed, B, H, KV, Sq, Sk, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, d)).astype(dtype),
            rng.normal(size=(B, KV, Sk, d)).astype(dtype),
            rng.normal(size=(B, KV, Sk, d)).astype(dtype))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _pallas(q, k, v, *, causal, bq, bk, dtype=jnp.float32):
    out = jops.flash_attn(*_jax(q, k, v, dtype=dtype), causal=causal,
                          block_q=bq, block_k=bk)
    return np.asarray(out.astype(jnp.float32))


def _topleft_oracle(q, k, v, causal):
    """Softmax attention in float64 with the top-left causal mask."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    kr = np.repeat(k.astype(np.float64), H // KV, axis=1)
    vr = np.repeat(v.astype(np.float64), H // KV, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kr) / math.sqrt(d)
    if causal:
        s = np.where(np.arange(Sk)[None, :] <= np.arange(Sq)[:, None], s,
                     -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), vr)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,d,bq,bk", JAX_SHAPES)
def test_matches_pallas_float32(B, H, KV, S, d, bq, bk, causal):
    q, k, v = _qkv(B * H + S, B, H, KV, S, S, d)
    got = ops.flash_attn(*_torch(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, d)
    want = _pallas(q, k, v, causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,d,bq,bk", JAX_SHAPES[:2])
def test_matches_pallas_bfloat16(B, H, KV, S, d, bq, bk, causal):
    q, k, v = _qkv(7 + S, B, H, KV, S, S, d)
    got = ops.flash_attn(*_torch(q, k, v, dtype=torch.bfloat16),
                         causal=causal)
    assert got.dtype == torch.bfloat16
    want = _pallas(q, k, v, causal=causal, bq=bq, bk=bk, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


# head dims no multiple of 16 (the qwen2.5-14b / starcoder2-15b smoke
# configs' 8, deepseek-v2's 24) and float16, which the Pallas kernel casts to
# float32 like any float: (d, dtype, atol).  float16 is held to two f16
# ulps of |o| ~ 2-4: bf16 precision (2^-9 of |o|) would not pass.
WIDE_CASES = [(8, "float32", 1e-5), (24, "float32", 1e-5),
              (8, "bfloat16", 5e-2), (64, "float16", 4e-3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype,tol", WIDE_CASES)
def test_any_head_dim_and_float_type_match_pallas(d, dtype, tol, causal):
    q, k, v = _qkv(31 + d, 2, 8, 2, 64, 64, d)
    tdtype = getattr(torch, dtype)
    got = ops.flash_attn(*_torch(q, k, v, dtype=tdtype), causal=causal)
    assert got.dtype == tdtype and got.shape == (2, 8, 64, d)
    want = _pallas(q, k, v, causal=causal, bq=32, bk=32,
                   dtype=getattr(jnp, dtype))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("Sq,Sk,block", [(64, 128, 64), (128, 64, 64),
                                          (100, 100, 100)])
def test_topleft_alignment_and_ragged_lengths_match_pallas(Sq, Sk, block):
    """Sq != Sk pins the top-left causal mask (query i sees keys 0..i);
    100 is no multiple of the port's tiles (the Pallas kernel, which asserts
    whole blocks, takes it as one block)."""
    q, k, v = _qkv(Sq + 3 * Sk, 1, 4, 2, Sq, Sk, 32)
    got = ops.flash_attn(*_torch(q, k, v), causal=True).numpy()
    want = _pallas(q, k, v, causal=True, bq=block, bk=block)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _topleft_oracle(q, k, v, True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_softmax_reference_at_equal_lengths(causal):
    q, k, v = _qkv(11, 2, 8, 2, 96, 96, 64)
    got = ops.flash_attn(*_torch(q, k, v), causal=causal).numpy()
    want = np.asarray(ref.flash_attention_ref(*_jax(q, k, v), causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_equals_two_chunk_attn_state_fold():
    """The kernel's fold == the JAX package's attn_state monoid over two KV
    chunks (as the JAX kernel test holds its Pallas kernel)."""
    rng = np.random.default_rng(9)
    S, d = 64, 16
    q, k, v = (rng.normal(size=(1, 1, S, d)).astype(np.float32)
               for _ in range(3))
    got = ops.flash_attn(*_torch(q, k, v), causal=False).numpy()
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = _jax(q, k, v)

    def state(sl):
        s = (jq[0, 0] @ jk[0, 0, sl].T) * scale
        mx = s.max(-1)
        e = jnp.exp(s - mx[:, None])
        return (mx, e.sum(-1), e @ jv[0, 0, sl])

    acc = jm.attn_state.combine(state(slice(0, 32)), state(slice(32, 64)))
    want = np.asarray(jm.attn_state.extract(acc))
    np.testing.assert_allclose(got[0, 0], want, rtol=1e-5, atol=1e-5)


def test_strided_views_and_no_key_rows():
    """The model's (B, S, heads, d) projections viewed as (B, heads, S, d)
    give the contiguous result; a query with no key (Sk = 0) is 0."""
    q, k, v = _qkv(5, 2, 4, 2, 24, 24, 16)
    tq, tk, tv = _torch(q, k, v)
    want = flash_attention(tq, tk, tv)
    got = flash_attention(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                            for t in (tq, tk, tv)))
    assert torch.equal(got, want)
    empty = torch.zeros((2, 2, 0, 16))
    out = flash_attention(tq, empty, empty)
    assert out.shape == tq.shape and torch.equal(out, torch.zeros_like(tq))


def test_cpu_runs_the_plain_version_without_a_launch():
    q, k, v = _torch(*_qkv(1, 1, 2, 1, 8, 8, 16))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert flash_attention.launches == before


def test_contract_errors():
    q, k, v = _torch(*_qkv(2, 1, 4, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros((1, 2, 4, 272)),) * 3)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_plain(*(torch.zeros((1, 2, 4, 272)),) * 3)
    with pytest.raises(ValueError, match="multiple of the KV"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError, match="all float32, all bfloat16"):
        flash_attention(q.to(torch.int32), k.to(torch.int32),
                        v.to(torch.int32))
    with pytest.raises(TypeError, match="all float32, all bfloat16"):
        flash_attention(q.half(), k, v.half())
    with pytest.raises(ValueError, match="alike"):
        flash_attention(q, k, v[:, :, :4])
    with pytest.raises(ValueError, match="cuda"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_binding_matches_the_c_signature():
    """The ctypes argument types are the C entry point's, in order."""
    src = LIBRARY.source.read_text()
    sig = src[src.index('extern "C" int flash_attention_launch('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "longlong": ctypes.c_longlong, "float": ctypes.c_float}
    want = [kinds[re.sub(r"const|\s", "", p.rsplit(None, 1)[0])]
            for p in params]
    assert LIBRARY.functions["flash_attention_launch"] == want
    assert LIBRARY.library_path().name.startswith("libflash_attention-")
