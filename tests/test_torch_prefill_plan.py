"""The prefill kernels' host plans, and their plain versions against the
JAX package at the ragged shapes of the card tests.

K2 (``qmatmul`` at M > 8) walks 128 x 128 output tiles in 64-deep K
steps, its K walk split where the tiles alone do not fill the card
(``bigm_splits``, shapes only); K3 (``flash_prefill_attention``) takes 64
flattened (token, group member) query rows a block, the row blocks in
reverse (``prefill_row_blocks``). Both plans are what the kernels read
on the card; here they are checked for covering the work exactly once.

The plain versions ``qmatmul_ref`` and ``attention_ref``, which the
card tests hold the kernels against, are held against the JAX Pallas
kernels in interpret mode (tiny widths: K 256, N 300, two kv heads).
Tolerance: bf16 activations, the JAX suite's rtol 2e-2 / atol 5e-3.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.ops.pallas.flash_prefill import (
    flash_prefill_attention as jax_flash_prefill,
)
from tinyllama_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from tinyllama_tpu_torch.interop import qtensor_from_numpy
from tinyllama_tpu_torch.ops.kernels import flash_attention, qmatmul
from tinyllama_tpu_torch.runtime.kvcache import KVCache

TOL = dict(rtol=2e-2, atol=5e-3)
H100_SMS = 132
#: TinyLlama-1.1B's layer weights, (K, N)
SHAPES = {"wqkv": (2048, 2560), "wo": (2048, 2048),
          "w_gateup": (2048, 11264), "w_down": (5632, 2048)}


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


# --- K2's plan ---------------------------------------------------------------


@pytest.mark.parametrize("M", [9, 33, 128, 200, 256, 512, 2048, 8192])
@pytest.mark.parametrize("name", list(SHAPES))
def test_bigm_blocks_cover_every_tile_and_step_once(name, M):
    K, N = SHAPES[name]
    splits = qmatmul.bigm_splits(M, N, K, H100_SMS)
    blocks = qmatmul.bigm_blocks(M, N, K, splits)
    n_mt, n_nt, nk = -(-M // 128), -(-N // 128), K // 64
    seen = collections.Counter(
        (mt, nt, k) for mt, nt, s0, s1 in blocks.values() for k in range(s0, s1))
    assert set(seen.values()) == {1}
    assert set(seen) == {(mt, nt, k) for mt in range(n_mt) for nt in range(n_nt)
                         for k in range(nk)}
    # every split has work; the N tiles of one M tile are neighbours
    assert all(s1 > s0 for _, _, s0, s1 in blocks.values())
    assert [blocks[(x, 0)][:2] for x in range(n_nt)] == [(0, nt) for nt in range(n_nt)]
    assert splits & (splits - 1) == 0 and splits <= qmatmul.BIGM_MAX_SPLITS
    # about a block an SM: within 4/3 of them, and a split more would
    # pass that (or the tiles alone reach it)
    assert len(blocks) <= 4 * H100_SMS // 3 or splits == 1
    assert splits == qmatmul.BIGM_MAX_SPLITS or 2 * len(blocks) > 4 * H100_SMS // 3
    if M >= 2048:
        assert splits == 1


def test_bigm_splits_read_host_sizes_only():
    splits = qmatmul.bigm_splits
    assert splits(128, 2048, 5632, H100_SMS) == 8
    assert splits(128, 2560, 2048, H100_SMS) == 8
    assert splits(128, 11264, 2048, H100_SMS) == 2
    assert splits(512, 2048, 5632, H100_SMS) == 2
    assert splits(128, 2048, 128, H100_SMS) == 2  # K's steps
    assert splits(9, 64, 2048, H100_SMS) == qmatmul.BIGM_MAX_SPLITS
    assert splits(8192, 11264, 2048, H100_SMS) == 1
    with pytest.raises(TypeError):
        splits(torch.tensor(128), 2048, 2048, H100_SMS)
    with pytest.raises(TypeError):
        splits(128, 2048, 2048, 0)


# --- K3's plan ---------------------------------------------------------------


@pytest.mark.parametrize("T,G", [(1, 8), (12, 4), (12, 8), (128, 8), (200, 4),
                                 (2048, 8)])
def test_prefill_row_blocks_cover_every_row_once_longest_first(T, G):
    blocks = flash_attention.prefill_row_blocks(T, G)
    rows = [r for blk in blocks for r in blk]
    assert sorted(rows) == list(range(T * G))
    assert all(0 < len(blk) <= flash_attention.QUERY_ROWS for blk in blocks)
    # the first block launched holds the last rows, whose causal walk is
    # the longest; each later block's last token comes no later
    last_token = [max(blk) // G for blk in blocks]
    assert last_token[0] == T - 1
    assert last_token == sorted(last_token, reverse=True)


# --- the plain versions against JAX at the card tests' ragged shapes ----------


def _q8_pair(L, K, N, seed):
    rng = np.random.default_rng(seed)
    qts = [jcodec.quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05,
                                       jnp.float32), "q8", layout="kn")
           for _ in range(L)]
    jw = jcodec.QTensor(jnp.stack([q.data for q in qts]),
                        jnp.stack([q.scales for q in qts]), "q8", "kn")
    return jw, qtensor_from_numpy((np.asarray(jw.data), np.asarray(jw.scales),
                                   "q8", "kn"))


@pytest.mark.parametrize("M", [9, 33, 200])
def test_qmatmul_ref_matches_pallas_bigm(M):
    K, N, li = 256, 300, 1
    jw, pw = _q8_pair(2, K, N, seed=M)
    jx = jnp.asarray(np.random.default_rng(M).standard_normal((M, K)), jnp.bfloat16)
    want = jax_qmatmul(jx, jw, out_dtype=jnp.float32, layer=jnp.int32(li),
                       interpret=True)
    got = qmatmul.qmatmul_ref(torch.from_numpy(_np(jx)).to(torch.bfloat16), pw,
                              torch.float32, torch.tensor([li], dtype=torch.int32))
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("T,pos", [(12, [0, 70]), (200, [70, 3])])
def test_attention_ref_matches_pallas_prefill(T, pos, G):
    """Two rows at unequal positions, a partial last query block."""
    Kh, S, L, d = 2, 320, 2, 64
    rng = np.random.default_rng(T + G)
    k = np.zeros((L, len(pos), Kh, S, d), np.float32)
    v = np.zeros_like(k)
    for b, p in enumerate(pos):
        k[:, b, :, :p + T] = rng.standard_normal((L, Kh, p + T, d))
        v[:, b, :, :p + T] = rng.standard_normal((L, Kh, p + T, d))
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jq = jnp.asarray(rng.standard_normal((len(pos), T, Kh * G, d)), jnp.bfloat16)
    want = jax_flash_prefill(jq, JaxKVCache(jk, jv, None, None), jnp.int32(1),
                             jnp.asarray(pos, jnp.int32), interpret=True)
    pc = KVCache(torch.from_numpy(_np(jk)).to(torch.bfloat16),
                 torch.from_numpy(_np(jv)).to(torch.bfloat16))
    got = flash_attention.attention_ref(
        torch.from_numpy(_np(jq)).to(torch.bfloat16), pc,
        torch.tensor([1], dtype=torch.int32), torch.tensor(pos, dtype=torch.int32))
    assert got.shape == jq.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL)


def test_prefill_ab_needs_a_card(capsys):
    """The parent-against-change tool exits with an error without a card,
    before it builds or measures anything."""
    from tinyllama_tpu_torch.tools import prefill_ab

    assert prefill_ab.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
