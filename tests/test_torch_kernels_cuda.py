"""The port's Hopper kernels against their plain versions.

K4 and K5 (ragged paged attention over fp and int8 pools), K7 (row
RMSNorm and LayerNorm), K1/K2/K3 (flash attention forward, fused
backward, split backward), K6 (paged decode), K8 (the MoE grouped
GEMM), K9 (the TP ring step) and K10 (the ring shift), with the layers
over them on the card: among them the training paths' K1/K2 at Llama-2
7B's shape and at bench.py's seq-2048 shape, K1/K2 and K7 inside
``torch.utils.checkpoint``, the MoE FFN of MoE GPT training, dropout
masks from a CUDA generator replayed by a recomputed block, and the
8-bit Adam moments' encoding on the card against the CPU's, sharded
training on an mp 2 mesh of two cards against one card, the ring
attention's K1 parts merged by their lse and K2 from the merged lse,
K1 / K2 / K3 at sq < sk (the gspmd sequence-parallel shape), and Llama
training on an sp 2 mesh of two cards in ring and ulysses mode against
one card. These tests need an NVIDIA Hopper GPU
(``cuda`` marker) and skip elsewhere; the tests that every kernel
wrapper raises on CPU tensors run anywhere. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch,
from the repository root::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

The K4 inputs (``MIXES``, ``_setup``) are shared with
tests/test_torch_paged_attention.py, which holds the plain version
against the JAX package on the CPU. K4 tolerances: rtol=atol=2e-4 in f32
(online against direct softmax, other summation orders), 2e-2 in bf16
(the kernel's output type, one rounding of an f32 result). Flash
tolerances hold each row (a query's out or dq, a key's dk or dv: the last
axis) on its own: the largest |got - want| in the row, in units of that
row's RMS of want, so that the small values of a late causal row count
as much as the large ones of an early row. See ``FLASH_TOL``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import Ring
from paddle_tpu_torch.distributed.pipeline import (CompiledPipeline,
                                                   ring_shift)
from paddle_tpu_torch.fusion import overlap_mm as tom
from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as tmd
from paddle_tpu_torch.incubate.nn.cuda import norms as tn
from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa
from paddle_tpu_torch.incubate.nn.cuda import ring as kring
from paddle_tpu_torch.incubate.nn.functional import moe_dispatch as fmd
from paddle_tpu_torch.optimizer import SGD

# name -> (query_lens, context_lens, n_heads, n_kv, n_pad)
MIXES = {
    "all_decode": ([1, 1, 1], [9, 33, 17], 4, 4, 0),
    "all_prefill": ([7, 20, 5], [7, 20, 5], 4, 4, 0),
    "mixed": ([1, 12, 1, 6], [25, 12, 40, 30], 4, 4, 0),
    "idle_rows": ([1, 0, 8, 0], [14, 0, 8, 0], 4, 4, 0),
    "padding": ([1, 12, 1, 6], [25, 12, 40, 30], 4, 4, 5),
    "gqa2": ([1, 9, 1], [22, 9, 31], 4, 2, 2),
}


def _setup(query_lens, context_lens, n_heads, n_kv, n_pad, d=32, page=16,
           pages_per_seq=4, seed=0):
    rng = np.random.RandomState(seed)
    n_rows = len(query_lens)
    total_pages = n_rows * pages_per_seq + 1
    n_tokens = int(np.sum(query_lens)) + n_pad
    q = rng.randn(n_tokens, n_heads, d).astype(np.float32)
    kp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    vp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    # shuffled page ids exercise the indirection; the unused tail slots
    # hold out-of-range ids, which both sides clamp into the pool
    bt = (1 + rng.permutation(n_rows * pages_per_seq)
          .reshape(n_rows, pages_per_seq)).astype(np.int32)
    for r, c in enumerate(context_lens):
        bt[r, -(-c // page):] = [-3, total_pages + 7][r % 2]
    ql = np.asarray(query_lens, np.int32)
    cl = np.asarray(context_lens, np.int32)
    return q, kp, vp, bt, cl, ql


def _cuda(arrays, dtype):
    q, kp, vp, bt, cl, ql = [torch.from_numpy(a).cuda() for a in arrays]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), bt, cl, ql


def _need_hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU to build and run the kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_hopper_kernel_matches_ref(mix, dtype):
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES[mix]
    arrays = _setup(ql, cl, nh, nkv, pad, seed=21)
    q, kp, vp, bt, cl, ql = _cuda(arrays, getattr(torch, dtype))
    before = tpa.ragged_paged_attention.launches
    got = tpa.ragged_paged_attention(q, kp, vp, bt, cl, ql)
    torch.cuda.synchronize()
    assert tpa.ragged_paged_attention.launches == before + 1
    want = tpa.ragged_paged_attention_ref(q, kp, vp, bt, cl, ql)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[int(ql.sum()):] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_hopper_kernel_head_dims(d):
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES["padding"]
    arrays = _setup(ql, cl, nh, nkv, pad, d=d, seed=22)
    case = _cuda(arrays, torch.bfloat16)
    got = tpa.ragged_paged_attention(*case)
    want = tpa.ragged_paged_attention_ref(*case)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_hopper_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES["mixed"]
    case = _cuda(_setup(ql, cl, nh, nkv, pad), torch.float16)
    counts = (tpa.ragged_paged_attention.launches,
              tpa.ragged_paged_attention.launches_q8, tn.rms_norm.launches,
              tn.layer_norm.launches)
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(*case)
    # K5: an fp16 q over int8 pools, and d 40 (int8 rows load 16 bytes)
    q8case = _q8(_cuda(_setup(ql, cl, nh, nkv, pad), torch.float32))
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q8case[0].half(), *q8case[1:])
    q8case = _q8(_cuda(_setup(ql, cl, nh, nkv, pad, d=40), torch.float32))
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(*q8case)
    # K7: fp16, a weight of another type, d not a multiple of 8
    x = torch.randn(4, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    with pytest.raises(ValueError):
        tn.rms_norm(x.half(), w.half())
    with pytest.raises(ValueError):
        tn.layer_norm(x.bfloat16(), w, w.bfloat16())
    with pytest.raises(ValueError):
        tn.rms_norm(x[:, :60].contiguous(), w[:60])
    assert (tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8, tn.rms_norm.launches,
            tn.layer_norm.launches) == counts


@pytest.mark.cuda
def test_mesh_mp2_training_matches_one_card(tmp_path):
    """Sharded training on two cards (one process a card, NCCL): the
    2-layer f32 GPT at GPT-3 1.3B's width, 3 steps on an mp 2 mesh, K1 /
    K2 on each rank's heads, a new batch a step, against one card: every
    loss and every gathered weight within 1e-4 in relative L2; the
    biases, which start at zero and so are Adam's normalised updates
    alone (their relative error is their gradient's, a sum over the
    tokens that cancels), within 1e-2, and the key third of the qkv
    bias, whose gradient is zero in exact arithmetic, within 3 lr."""
    _need_hopper()
    if torch.cuda.device_count() < 2:
        pytest.skip("an mp 2 mesh needs two cards")
    import _torch_mesh_workers as W
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.incubate.nn.cuda import _build

    _build.build_all(("flash_attn", "norms"))
    spawn(W.cuda_mp2, (str(tmp_path),), nprocs=2)
    r = dict(np.load(tmp_path / "cuda_mp2.npz"))
    np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)
    assert (r["launches"] == [2 * 2 * W.STEPS, 2 * W.STEPS]).all()
    for name in [k[4:] for k in r if k.startswith("ref:")]:
        got, want = r[name], r["ref:" + name]
        if name.endswith("qkv_proj.bias"):
            h = want.shape[0] // 3
            np.testing.assert_allclose(got[h:2 * h], want[h:2 * h],
                                       atol=3e-4, err_msg=name)
            got, want = np.delete(got, np.s_[h:2 * h]), \
                np.delete(want, np.s_[h:2 * h])
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= (1e-2 if name.endswith(".bias") else 1e-4), (name,
                                                                   rel)


@pytest.mark.cuda
def test_mesh_sp2_training_matches_one_card(tmp_path):
    """Sequence parallelism on two cards (one process a card, NCCL): the
    2-layer f32 Llama at Llama-2 7B's width, 3 steps on 2 x 512 tokens on
    an sp 2 mesh in ring mode (rank r: K1 on r + 1 parts of 256 tokens,
    K2 on each) and in ulysses mode (K1 / K2 on 16 heads over the 512),
    against one card: every loss and every gathered weight within 1e-4
    in relative L2, each rank's launches as the mode runs them."""
    _need_hopper()
    if torch.cuda.device_count() < 2:
        pytest.skip("an sp 2 mesh needs two cards")
    import _torch_sp_workers as S
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.incubate.nn.cuda import _build

    _build.build_all(("flash_attn", "norms"))
    spawn(S.cuda_sp2, (str(tmp_path),), nprocs=2)
    r = dict(np.load(tmp_path / "cuda_sp2.npz"))
    steps, layers = S.W.STEPS, 2
    # recompute: two forwards a layer; rank 0 (written) one ring part
    want = {"ring": [2 * layers * steps, layers * steps, 0],
            "ulysses": [2 * layers * steps, layers * steps, 0]}
    for mode in ("ring", "ulysses"):
        np.testing.assert_allclose(r[mode + "_losses"], r["ref_losses"],
                                   rtol=1e-4, err_msg=mode)
        assert list(r[mode + "_launches"]) == want[mode], mode
        for name in [k[4:] for k in r if k.startswith("ref:")]:
            got, ref = r["%s:%s" % (mode, name)], r["ref:" + name]
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= 1e-4, (mode, name, rel)


# ring attention: q, k, v cut into SP_PARTS parts of the sequence, as
# ranks of an sp axis hold them: (b, s, h, d)
SP_RING_SHAPE = (1, 1024, 4, 128)
SP_PARTS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_parts_merged_by_lse(dtype):
    """The ring's work on one card: K1 on each rank's own part (causal)
    and on the earlier ones (full), merged by their lse in f32
    (``sequence_parallel.merge_parts``), against the plain attention
    over the whole sequence; K2 on every (rank, part) pair from the
    MERGED out and lse, the gradients summed, against the plain
    gradients."""
    _need_hopper()
    from paddle_tpu_torch.distributed.sequence_parallel import merge_parts

    b, S, h, d = SP_RING_SHAPE
    n = S // SP_PARTS
    dt = getattr(torch, dtype)
    q, k, v, do = _flash_inputs(b, S, S, h, d, dt, seed=11)
    scale = d ** -0.5
    want_out, want_lse = _ref_fwd(q, k, v, True, scale)
    want = _ref_bwd(q, k, v, want_out, want_lse, do, True, scale)

    def part(x, i):
        return x[:, i * n:(i + 1) * n]

    outs, lses = [], []
    for r in range(SP_PARTS):
        out = lse = None
        for c in range(r + 1):
            out, lse = merge_parts(out, lse, *fa.flash_fwd(
                part(q, r), part(k, c), part(v, c), c == r, scale))
        outs.append(out.to(dt))
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    grads = [torch.zeros(b, S, h, d, device="cuda") for _ in range(3)]
    before = fa.flash_bwd_fused.launches
    for r in range(SP_PARTS):
        rows = lse[..., r * n:(r + 1) * n].contiguous()
        for c in range(r + 1):
            dq, dk, dv = fa.flash_bwd(part(q, r), part(k, c), part(v, c),
                                      part(out, r), rows, part(do, r),
                                      c == r, scale)
            part(grads[0], r).add_(dq)
            part(grads[1], c).add_(dk)
            part(grads[2], c).add_(dv)
    torch.cuda.synchronize()
    pairs = SP_PARTS * (SP_PARTS + 1) // 2
    assert fa.flash_bwd_fused.launches == before + pairs
    _assert_close(out, want_out, FLASH_TOL[dtype], "merged out")
    _assert_lse_close(lse, want_lse)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _assert_close(g, w, FLASH_TOL[dtype], "summed " + name)


# gspmd on an sp axis: rank r's queries over the keys up to its own part
# (bottom-right causal): (b, sq, sk, h)
SP_GSPMD_SHAPES = {"r1_of_2": (1, 512, 1024, 4), "r3_of_4": (1, 256, 1024, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "split"])
@pytest.mark.parametrize("shape", sorted(SP_GSPMD_SHAPES))
@pytest.mark.parametrize("d", [64, 128])
def test_flash_at_sq_lt_sk_of_an_sp_rank(d, shape, kernel):
    """K1 and the backward at the gspmd mode's shape: the last sq queries
    of a causal sequence over all sk keys, K2 (called directly) and K3
    (the backward's route at sq < sk), against the plain versions, bf16,
    the queries taken from the whole sequence's own rows."""
    _need_hopper()
    b, sq, sk, h = SP_GSPMD_SHAPES[shape]
    q, k, v, do = _flash_inputs(b, sk, sk, h, d, torch.bfloat16, seed=d)
    q, do = q[:, sk - sq:], do[:, sk - sq:]
    scale = d ** -0.5
    assert not fa.uses_fused_bwd(sq, sk, d)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    want_out, want_lse = _ref_fwd(q, k, v, True, scale)
    _assert_close(out, want_out, FLASH_TOL["bfloat16"], "out")
    _assert_lse_close(lse, want_lse)
    fn = fa.flash_bwd_fused if kernel == "fused" else fa.flash_bwd_split
    got = fn(q, k, v, want_out, want_lse, do, True, scale)
    torch.cuda.synchronize()
    want = _ref_bwd(q, k, v, want_out, want_lse, do, True, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, w, FLASH_TOL["bfloat16"], "%s %s" % (kernel, name))


def test_kernel_wrappers_raise_on_cpu_tensors():
    """Every kernel wrapper takes CUDA tensors only: the plain versions
    serve the CPU, chosen by the callers (``_ragged_attn``, the
    functional norms), never by the wrapper."""
    ql, cl, nh, nkv, pad = MIXES["mixed"]
    case = [torch.from_numpy(a) for a in _setup(ql, cl, nh, nkv, pad)]
    counts = (tpa.ragged_paged_attention.launches,
              tpa.ragged_paged_attention.launches_q8, tn.rms_norm.launches,
              tn.layer_norm.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.ragged_paged_attention(*case)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.ragged_paged_attention(*_q8(case))
    x, w = torch.randn(3, 64), torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        tn.rms_norm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tn.rms_norm(x, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        tn.layer_norm(x, w, w)
    gmm = tmd.grouped_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        tmd.grouped_matmul(torch.randn(tmd.BM, 8), torch.randn(2, 8, 16),
                           torch.zeros(1, dtype=torch.int32))
    assert (tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8, tn.rms_norm.launches,
            tn.layer_norm.launches) == counts
    assert tmd.grouped_matmul.launches == gmm
    ring = Ring(["cpu"] * 2)
    rings = (kring.mm_step.launches, kring.shift.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kring.mm_step([torch.randn(4, 8)] * 2, [torch.randn(8, 8)] * 2,
                      ring)
    with pytest.raises(ValueError, match="CUDA"):
        kring.shift([torch.randn(4, 8)] * 2, ring)
    assert (kring.mm_step.launches, kring.shift.launches) == rings


# ------------------------------------------------------------------ K5
def _q8(case):
    """The same batch over int8 pools: the fp pools quantized by the
    port's write rule (one scale per key row)."""
    q, kp, vp, *meta = case
    return (q, tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp), *meta)


# K5 against its plain version, row by row (see _row_err): both decode
# the same int8 rows to the same f32 values, so the difference is the
# online against the direct softmax and, in bf16, the output's rounding.
Q8_TOL = {"float32": 1e-3, "bfloat16": 6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_q8_kernel_matches_ref(mix, dtype):
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES[mix]
    case = _q8(_cuda(_setup(ql, cl, nh, nkv, pad, seed=31), torch.float32))
    q = case[0].to(getattr(torch, dtype))
    case = (q,) + case[1:]
    before = (tpa.ragged_paged_attention.launches,
              tpa.ragged_paged_attention.launches_q8)
    got = tpa.ragged_paged_attention(*case)
    torch.cuda.synchronize()
    assert (tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8) == \
        (before[0], before[1] + 1)
    want = tpa.ragged_paged_attention_ref(*case)
    n_live = int(case[5].sum())
    _assert_close(got[:n_live], want[:n_live], Q8_TOL[dtype], mix)
    assert (got[n_live:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_q8_kernel_groups_dims_pages(group, d, page):
    """The decode + prefill + padding mix with 8 query heads over 8, 2
    and 1 kv heads, bf16 q."""
    _need_hopper()
    ql, cl, _, _, pad = MIXES["padding"]
    case = _q8(_cuda(_setup(ql, cl, 8, 8 // group, pad, d=d, page=page,
                            seed=32), torch.float32))
    case = (case[0].bfloat16(),) + case[1:]
    got = tpa.ragged_paged_attention(*case)
    want = tpa.ragged_paged_attention_ref(*case)
    n_live = int(case[5].sum())
    _assert_close(got[:n_live], want[:n_live], Q8_TOL["bfloat16"],
                  "group %d d %d page %d" % (group, d, page))
    assert (got[n_live:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_kernel_matches_k4_on_the_same_values(dtype):
    """K5 over int8 pages against K4 over the pool they decode to. The
    scales are powers of two, so every decoded value (a 7-bit code times
    2^k) is exact in bf16 too: both kernels then stage the same f32 keys
    and values and run the same arithmetic, so they agree to the bit."""
    _need_hopper()
    dt = getattr(torch, dtype)
    ql, cl, nh, nkv, pad = MIXES["gqa2"]
    q, kp, vp, *meta = _cuda(_setup(ql, cl, nh, nkv, pad, seed=33),
                             torch.float32)
    g = torch.Generator(device="cuda").manual_seed(5)

    def pool(shape):
        q8 = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        e = torch.randint(-9, -3, shape[:3], generator=g, device="cuda")
        return {"q8": q8, "s": torch.exp2(e.float())}

    k8, v8 = pool(tuple(kp.shape)), pool(tuple(vp.shape))
    kf, vf = (tpa._dequant(p["q8"], p["s"]).to(dt) for p in (k8, v8))
    got = tpa.ragged_paged_attention(q.to(dt), k8, v8, *meta)
    want = tpa.ragged_paged_attention(q.to(dt), kf, vf, *meta)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -------------------------------------------- K4 / K5: splits and graphs
# name -> (query_lens, context_lens, n_heads, n_kv, d, page, pages_per_seq).
# A block walks at most 512 keys of a tile's causal range (the kernel's
# split); longer tiles leave partials that a second kernel merges.
LONG_MIXES = {
    # GPT-3 1.3B's context: decode rows at 2048 keys and a prefill chunk
    "gpt_2048": ([1, 1, 1, 1, 16], [2048, 2047, 1500, 513, 2048], 4, 4,
                 128, 16, 128),
    # Llama-2 7B's context
    "llama_4096": ([1, 1, 1, 1], [4096, 4000, 3333, 1025], 4, 4, 128, 16,
                   256),
    # page 24: the 512-key split boundaries fall inside pages
    "split_in_page": ([1, 40, 1], [530, 1040, 1537], 4, 4, 64, 24, 72),
    # 64 tokens over 540 keys: the last tile's split 1 (keys 512-539) is
    # wholly past the causal limit of its first tokens, whose m stays -inf
    "past_causal": ([64, 1], [540, 600], 4, 4, 64, 16, 40),
    # a 512-token prefill row beside decode rows
    "prefill_512": ([512, 1, 1], [512, 2048, 700], 4, 4, 64, 16, 128),
    "gqa4": ([1, 50, 1], [1999, 700, 33], 8, 2, 128, 16, 128),
    "gqa8": ([1, 30, 1], [1024, 530, 1], 8, 1, 128, 16, 128),
    "page128": ([1, 33, 1], [1500, 600, 129], 4, 4, 128, 128, 16),
}
LONG_ROW_TOL = {"float32": 1e-3, "bfloat16": 6e-2}


def _long_case(name, dtype, quant, seed=41):
    ql, cl, nh, nkv, d, page, pps = LONG_MIXES[name]
    n_rows = len(ql)
    g = torch.Generator(device="cuda").manual_seed(seed)
    total = n_rows * pps + 1
    q = torch.randn(int(sum(ql)) + 3, nh, d, generator=g, device="cuda")
    kp, vp = (torch.randn(nkv, total, page, d, generator=g, device="cuda")
              for _ in range(2))
    rng = np.random.RandomState(seed)
    bt = (1 + rng.permutation(n_rows * pps)).reshape(n_rows, pps)
    for r, c in enumerate(cl):
        bt[r, -(-c // page):] = [-1, total + 5][r % 2]
    meta = [torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")
            for a in (bt, cl, ql)]
    if quant:
        kp, vp = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q.to(dtype), kp, vp, *meta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("name", sorted(LONG_MIXES))
def test_ragged_kernel_long_rows_and_splits(name, pool, dtype):
    """K4 and K5 against the plain version on rows past one split: GPT-3's
    2048 and Llama-2's 4096 keys, split boundaries inside a page, a split
    past the causal limit of part of a tile, a 512-token prefill row,
    groups 4 and 8, d 64, page 128."""
    _need_hopper()
    case = _long_case(name, getattr(torch, dtype), pool == "int8")
    counts = (tpa.ragged_paged_attention.launches,
              tpa.ragged_paged_attention.launches_q8)
    got = tpa.ragged_paged_attention(*case)
    torch.cuda.synchronize()
    grew = (tpa.ragged_paged_attention.launches - counts[0],
            tpa.ragged_paged_attention.launches_q8 - counts[1])
    assert grew == ((0, 1) if pool == "int8" else (1, 0))
    want = tpa.ragged_paged_attention_ref(*case)
    n_live = int(case[5].sum())
    _assert_close(got[:n_live], want[:n_live], LONG_ROW_TOL[dtype],
                  "%s %s %s" % (name, pool, dtype))
    if dtype == "float32" and pool == "fp":
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert (got[n_live:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_ragged_kernel_is_deterministic(pool):
    """Two launches on the same inputs give the same bits: the warps and
    the splits are merged in a fixed order."""
    _need_hopper()
    case = _long_case("gpt_2048", torch.bfloat16, pool == "int8")
    a = tpa.ragged_paged_attention(*case)
    b = tpa.ragged_paged_attention(*case)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_ragged_kernel_in_a_cuda_graph(pool):
    """One call captured in a CUDA graph, replayed after new context and
    query lengths are written into the captured tensors, matches the plain
    version on the new lengths: nothing is sized from device values and
    nothing waits on the host."""
    _need_hopper()
    q, kp, vp, bt, cl, ql = _long_case("gpt_2048", torch.bfloat16,
                                       pool == "int8")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: build, bind, allocate
        tpa.ragged_paged_attention(q, kp, vp, bt, cl, ql)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.ragged_paged_attention(q, kp, vp, bt, cl, ql)
    for new_cl, new_ql in (([700, 2048, 1, 1300, 40], [1, 1, 1, 1, 16]),
                           ([300, 0, 2000, 1024, 1900], [8, 0, 1, 1, 9])):
        cl.copy_(torch.tensor(new_cl, dtype=torch.int32))
        ql.copy_(torch.tensor(new_ql, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = tpa.ragged_paged_attention_ref(q, kp, vp, bt, cl, ql)
        n_live = int(sum(new_ql))
        _assert_close(out[:n_live], want[:n_live], LONG_ROW_TOL["bfloat16"],
                      "graph %s %s" % (pool, new_cl))
        assert (out[n_live:] == 0).all()


# ------------------------------------------------------------------ K7
# each element of the kernel's output against the plain version's:
# |got - want| <= rel * |want| + 1e-6 * RMS of want's row. bf16: rel
# 2^-7, one bf16 ulp (the two round f32 values that differ in the last
# bits, summed in other orders, and may land on either side of a rounding
# boundary). f32: rel 1e-5. The row floor, far below either, covers
# LayerNorm's x - mu where x is within rounding of mu.
NORM_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
NORM_ROW_FLOOR = 1e-6


def _norm_ratio(got, want, rel):
    """Largest |got - want| over its allowance (<= 1 passes)."""
    w = want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    allow = rel * w.abs() + NORM_ROW_FLOOR * rms + 1e-30
    return ((got.float() - w).abs() / allow).max().item()


def _norm_inputs(n, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.5 * torch.randn(n, d, generator=g, device="cuda") + 0.3).to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rms", "rms_bias", "ln"])
@pytest.mark.parametrize("n", [136, 1001, 1, 12, 8192])
@pytest.mark.parametrize("d", [2048, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_kernel_matches_ref(dtype, d, n, kind):
    _need_hopper()
    x, w, b = _norm_inputs(n, d, getattr(torch, dtype), seed=d + n)
    if kind == "ln":
        fn, ref, args = tn.layer_norm, tn.layer_norm_ref, (x, w, b, 1e-5)
    else:
        bias = b if kind == "rms_bias" else None
        fn, ref, args = tn.rms_norm, tn.rms_norm_ref, (x, w, bias, 1e-5)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ratio = _norm_ratio(got, ref(*args), NORM_REL[dtype])
    print("%s %s d %d n %d: largest error %.3g of its allowance"
          % (kind, dtype, d, n, ratio))
    assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 136, 24576])
def test_norm_kernel_odd_widths(d):
    """Widths that leave threads idle (8, 136) or fill 1024 threads with
    3 of their 4 register vectors (24576), on 3-D input."""
    _need_hopper()
    x, w, b = _norm_inputs(6, d, torch.float32, seed=d)
    x = x.reshape(2, 3, d)
    for got, want in ((tn.rms_norm(x, w, None, 1e-6),
                       tn.rms_norm_ref(x, w, None, 1e-6)),
                      (tn.layer_norm(x, w, b, 1e-6),
                       tn.layer_norm_ref(x, w, b, 1e-6))):
        assert got.shape == x.shape
        assert _norm_ratio(got, want, NORM_REL["float32"]) <= 1.0


def _norm_call(kind, x, w, b, eps, **kw):
    """(kernel, plain version, result of each) of one K7 call."""
    if kind == "ln":
        fn, ref, args = tn.layer_norm, tn.layer_norm_ref, (x, w, b, eps)
    else:
        fn, ref = tn.rms_norm, tn.rms_norm_ref
        args = (x, w, b if kind == "rms_bias" else None, eps)
    return fn, fn(*args, **kw), ref(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("adds", ["res", "bias+res", "bias"])
@pytest.mark.parametrize("kind", ["rms", "rms_bias", "ln"])
@pytest.mark.parametrize("n", [1, 12, 136, 1001, 8192])
@pytest.mark.parametrize("d", [2048, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_kernel_fused_matches_ref(dtype, d, n, kind, adds):
    """The fused form (a bias and / or a residual added to x first, in
    the same launch): the norm within NORM_REL of the plain version, the
    sum bitwise PyTorch's two adds, one launch counted as fused."""
    _need_hopper()
    dt = getattr(torch, dtype)
    x, w, b = _norm_inputs(n, d, dt, seed=3 * d + n)
    r, lb, _ = _norm_inputs(n, d, dt, seed=5 * d + n)
    kw = dict(bias=lb if "bias" in adds else None,
              residual=r if "res" in adds else None)
    fn = tn.layer_norm if kind == "ln" else tn.rms_norm
    before = (fn.launches, fn.launches_fused)
    fn, got, want = _norm_call(kind, x, w, b, 1e-5, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_fused) == (before[0] + 1,
                                                before[1] + 1)
    if kw["residual"] is not None:
        (got, got_sum), (want, want_sum) = got, want
        added = x + kw["bias"] if kw["bias"] is not None else x
        assert torch.equal(got_sum, added + r)
        assert torch.equal(want_sum, added + r)
    ratio = _norm_ratio(got, want, NORM_REL[dtype])
    print("%s + %s %s d %d n %d: largest error %.3g of its allowance"
          % (kind, adds, dtype, d, n, ratio))
    assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [136, 8192])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_kernel_bitwise_across_launches(kind, n):
    """Two launches on the same inputs agree bit for bit, in both forms
    (a block a row at 136 rows, the persistent grid at 8192), plain and
    fused."""
    _need_hopper()
    x, w, b = _norm_inputs(n, 4096, torch.bfloat16, seed=n)
    r, lb, _ = _norm_inputs(n, 4096, torch.bfloat16, seed=n + 1)
    for kw in ({}, dict(bias=lb, residual=r)):
        _, one, _ = _norm_call(kind, x, w, b, 1e-5, **kw)
        _, two, _ = _norm_call(kind, x, w, b, 1e-5, **kw)
        for a, c in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (one, two))):
            assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 8192])
def test_norm_kernel_cuda_graph(n):
    """Captured in a CUDA graph on a side stream and replayed on new
    values, the plain and the fused calls give what eager calls give."""
    _need_hopper()
    x, w, b = _norm_inputs(n, 2048, torch.bfloat16, seed=41 + n)
    r, lb, _ = _norm_inputs(n, 2048, torch.bfloat16, seed=43 + n)

    def calls():
        return (tn.rms_norm(x, w, None, 1e-6),
                tn.layer_norm(x, w, b, 1e-5, bias=lb, residual=r))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rms, (ln, s) = calls()
    x2, _, _ = _norm_inputs(n, 2048, torch.bfloat16, seed=47 + n)
    r2, _, _ = _norm_inputs(n, 2048, torch.bfloat16, seed=53 + n)
    x.copy_(x2)
    r.copy_(r2)
    graph.replay()
    torch.cuda.synchronize()
    want_rms, (want_ln, want_s) = calls()
    assert torch.equal(rms, want_rms)
    assert torch.equal(ln, want_ln)
    assert torch.equal(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 136, 24576])
def test_norm_kernel_fused_odd_widths(d):
    """The fused form at the widths of test_norm_kernel_odd_widths, on
    3-D input, f32 and bf16."""
    _need_hopper()
    for dt, rel in ((torch.float32, NORM_REL["float32"]),
                    (torch.bfloat16, NORM_REL["bfloat16"])):
        x, w, b = _norm_inputs(6, d, dt, seed=d)
        r, lb, _ = _norm_inputs(6, d, dt, seed=d + 1)
        x, r = x.reshape(2, 3, d), r.reshape(2, 3, d)
        for kind in ("rms", "ln"):
            _, (got, s), (want, want_s) = _norm_call(
                kind, x, w, b, 1e-6, bias=lb, residual=r)
            assert got.shape == s.shape == x.shape
            assert torch.equal(s, want_s)
            assert _norm_ratio(got, want, rel) <= 1.0


@pytest.mark.cuda
def test_norm_fused_refusals():
    """What the fused form does not take raises before any launch: a
    residual of another shape, type or layout, a bias of another length
    or type."""
    _need_hopper()
    x, w, b = _norm_inputs(4, 64, torch.float32, seed=1)
    counts = (tn.rms_norm.launches, tn.rms_norm.launches_fused,
              tn.layer_norm.launches, tn.layer_norm.launches_fused)
    for kw in (dict(residual=x[:2]), dict(residual=x.bfloat16()),
               dict(residual=x.t().contiguous().t()),
               dict(residual=x, bias=b[:32]),
               dict(residual=x, bias=b.bfloat16()), dict(bias=w.cpu())):
        with pytest.raises(ValueError):
            tn.rms_norm(x, w, None, 1e-6, **kw)
        with pytest.raises(ValueError):
            tn.layer_norm(x, w, b, 1e-5, **kw)
    assert (tn.rms_norm.launches, tn.rms_norm.launches_fused,
            tn.layer_norm.launches, tn.layer_norm.launches_fused) == counts


@pytest.mark.cuda
def test_norm_plan_forms():
    """A block a row (one vector of 8 values a thread) up to one wave of
    resident blocks, then the persistent grid (two vectors a thread): at
    most one wave, every block as many rows."""
    _need_hopper()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, d in (("rms", 4096), ("ln", 2048)):
        form, blocks, threads, vecs = tn.plan(136, d, kind)
        assert (form, blocks, threads, vecs) == ("rows", 136, d // 8, 1)
        form, blocks, threads, vecs = tn.plan(8192, d, kind, residual=True)
        assert (form, threads, vecs) == ("persistent", d // 16, 2)
        assert sms <= blocks < 8192
        rows = -(-8192 // blocks)
        assert -(-8192 // rows) == blocks


@pytest.mark.cuda
def test_fused_functional_one_launch():
    """``fused_rms_norm`` / ``fused_layer_norm`` with ``bias`` and
    ``residual`` on the card: one K7 launch each, the plain version's
    result."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops

    _need_hopper()
    x, w, b = _norm_inputs(2 * 68, 4096, torch.bfloat16, seed=61)
    r, lb, _ = _norm_inputs(2 * 68, 4096, torch.bfloat16, seed=62)
    x, r = x.reshape(2, 68, 4096), r.reshape(2, 68, 4096)
    for fused, fn, ref in (
            (fused_ops.fused_rms_norm, tn.rms_norm, tn.rms_norm_ref),
            (fused_ops.fused_layer_norm, tn.layer_norm, tn.layer_norm_ref)):
        before = fn.launches
        out, s = fused(x, w, b, 1e-5, bias=lb, residual=r)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want, want_s = ref(x, w, b, 1e-5, bias=lb, residual=r)
        assert torch.equal(s, want_s)
        assert _norm_ratio(out, want, NORM_REL["bfloat16"]) <= 1.0


# ------------------------------------------------------------ K1, K2, K3
# largest error of a row in units of its RMS (see _row_err). f32: exact
# f32 products summed in other orders (K2's dq by atomics in a changing
# order); read at <= 3.5e-6 on an H100, and 3.1e-4 on dq's first causal
# row, whose exact value is zero. bf16: p and ds rounded to bf16 at a
# running rather than the final row max, and bf16 outputs; read at 0.019
# to 0.035 on an H100, here and in chip_smoke.py, while a 64-key tile left
# out of a late causal row reads 1.6 (test below). lse, f32 from the same
# f32 scores: read at <= 1.9e-6.
FLASH_TOL = {"float32": 1e-3, "bfloat16": 6e-2}
LSE_ATOL = 1e-4
# name -> (b, sq, sk, h): s not a multiple of any tile; sq < sk takes
# the bottom-right causal offset
FLASH_SHAPES = {"ragged": (2, 200, 200, 3), "sq_lt_sk": (2, 77, 200, 3)}


def _flash_inputs(b, sq, sk, h, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(s):
        return torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)

    return mk(sq), mk(sk), mk(sk), mk(sq)          # q, k, v, do


def _head_major(*xs):
    return [x.transpose(1, 2) for x in xs]


def _ref_fwd(q, k, v, causal, scale):
    out, lse = fa.flash_fwd_ref(*_head_major(q, k, v), causal, scale)
    return out.transpose(1, 2), lse[..., 0]


def _ref_bwd(q, k, v, out, lse, do, causal, scale):
    grads = fa.flash_bwd_ref(*_head_major(q, k, v, out), lse[..., None],
                             do.transpose(1, 2), causal, scale)
    return _head_major(*grads)


def _row_err(got, want):
    """Max abs error, and the largest error of a row (the last axis) in
    units of that row's RMS of ``want``, or of 1% of the whole tensor's
    RMS where that is larger: a row whose exact value is zero (dq of the
    first query under causal attention) holds only rounding noise."""
    w = want.float()
    err = (got.float() - w).abs()
    floor = 1e-2 * w.square().mean().sqrt().item() + 1e-30
    rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)
    return err.max().item(), (err / rms).max().item()


def _assert_close(got, want, tol, what):
    assert bool(torch.isfinite(got).all()), "%s: non-finite" % what
    err, rel = _row_err(got, want)
    # shown with -rP: the readings the limits were set from
    print("%s: max abs err %.3g, %.3g of its row's RMS" % (what, err, rel))
    assert rel <= tol, "%s: max abs err %.3g, %.3g of its row's RMS > %g" \
        % (what, err, rel, tol)


def _assert_lse_close(got, want):
    assert bool(torch.isfinite(got).all()), "lse: non-finite"
    err = (got - want).abs().max().item()
    print("lse: max abs err %.3g" % err)
    assert err <= LSE_ATOL, "lse: max abs err %.3g > %g" % (err, LSE_ATOL)


def test_row_check_rejects_a_dropped_late_tile():
    """The bf16 limit passes a second rounding of the same attention but
    fails one that leaves out a 64-key tile for the last 64 queries of a
    1024-token causal sequence, whose outputs are ~20x smaller than the
    first rows' (plain versions, on the CPU)."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 1024, 128, generator=g) for _ in range(3))
    scale = 128 ** -0.5
    want, _ = fa.flash_fwd_ref(*(x.bfloat16() for x in (q, k, v)), True,
                               scale)
    again, _ = fa.flash_fwd_ref(q, k, v, True, scale)
    _assert_close(again.bfloat16(), want, FLASH_TOL["bfloat16"], "rounding")
    keep = torch.ones(1024, dtype=torch.bool)
    keep[896:960] = False              # keys the last 64 queries then miss
    late, _ = fa.flash_fwd_ref(q[:, :, 960:], k[:, :, keep], v[:, :, keep],
                               True, scale)
    broken = torch.cat([again[:, :, :960], late], dim=2).bfloat16()
    rel = _row_err(broken, want)[1]
    print("dropped tile: %.3g of its row's RMS" % rel)
    assert rel > 3 * FLASH_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_matches_ref(dtype, d, causal, shape):
    _need_hopper()
    b, sq, sk, h = FLASH_SHAPES[shape]
    q, k, v, _ = _flash_inputs(b, sq, sk, h, d, getattr(torch, dtype))
    scale = d ** -0.5
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_out, want_lse = _ref_fwd(q, k, v, causal, scale)
    tol = FLASH_TOL[dtype]
    _assert_close(out, want_out, tol, "out")
    _assert_lse_close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["ragged-fused", "ragged-split",
                                   "sq_lt_sk-split"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_matches_ref(dtype, d, causal, route):
    _need_hopper()
    shape, kernel = route.split("-")
    b, sq, sk, h = FLASH_SHAPES[shape]
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, getattr(torch, dtype),
                                seed=1)
    scale = d ** -0.5
    out, lse = _ref_fwd(q, k, v, causal, scale)
    fn = fa.flash_bwd_fused if kernel == "fused" else fa.flash_bwd_split
    before = fn.launches
    got = fn(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _ref_bwd(q, k, v, out, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, w, FLASH_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_gqa_strided(dtype):
    """The differentiable entry on q/k/v sliced out of one fused
    [b, s, 3, h, d] projection (strided, no copy), with 4 query heads on
    2 kv heads, against the plain versions on k/v repeated over each
    group, from the same saved out and lse, with dk and dv summed back
    over the group."""
    _need_hopper()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, hk, d = 2, 150, 4, 2, 64
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)
    q = qkv[:, :, 0].detach().requires_grad_()
    kv = torch.randn(b, s, 2, hk, d, generator=g, device="cuda").to(dt)
    k = kv[:, :, 0].detach().requires_grad_()
    v = kv[:, :, 1].detach().requires_grad_()
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    fwd0, bwd0 = fa.flash_fwd.launches, fa.flash_bwd_fused.launches
    out = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches) == \
        (fwd0 + 1, bwd0 + 1)
    scale = d ** -0.5
    qd, kr, vr = (x.detach().repeat_interleave(h // x.shape[2], dim=2)
                  for x in (q, k, v))
    want_out, _ = _ref_fwd(qd, kr, vr, True, scale)
    saved_out, saved_lse = fa.flash_fwd(qd, kr, vr, True, scale)
    dq, dk, dv = _ref_bwd(qd, kr, vr, saved_out, saved_lse, do, True, scale)
    want = [dq] + [x.float().reshape(b, s, hk, h // hk, d).sum(3)
                   for x in (dk, dv)]
    tol = FLASH_TOL[dtype]
    _assert_close(out, want_out, tol, "out")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a, w, tol, name)


# K1's wgmma + TMA route (bf16, head_dim 64 and 128) on q/k/v sliced out
# of one fused [b, s, 3, h, d] projection, as the training path passes
# them: name -> (b, sq, sk, h), s ragged against the 128-row tiles, and
# sq < sk (q from its own projection).
WGMMA_SHAPES = {"ragged": (2, 1000, 1000, 3), "short": (1, 77, 77, 2),
                "sq_lt_sk": (2, 300, 1024, 2), "one_tile": (1, 128, 128, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(WGMMA_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_wgmma_on_fused_qkv_views(d, causal, shape):
    _need_hopper()
    b, sq, sk, h = WGMMA_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(d + sq)
    qkv = torch.randn(b, sk, 3, h, d, generator=g,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if sq != sk:
        q = torch.randn(b, sq, 3, h, d, generator=g,
                        device="cuda").bfloat16()[:, :, 0]
    scale = d ** -0.5
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_out, want_lse = _ref_fwd(q, k, v, causal, scale)
    _assert_close(out, want_out, FLASH_TOL["bfloat16"],
                  "out d %d causal %d %s" % (d, causal, shape))
    _assert_lse_close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_autograd_fused_qkv(d):
    """K1's new route under the differentiable entry: the forward on the
    fused projection's views, K2's gradients from its saved out and lse,
    against the plain versions."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(7)
    b, s, h = 2, 300, 2
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").bfloat16()
    qkv.requires_grad_()
    do = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
    fwd0, bwd0 = fa.flash_fwd.launches, fa.flash_bwd_fused.launches
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             causal=True)
    (dqkv,) = torch.autograd.grad(out, (qkv,), do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches) == \
        (fwd0 + 1, bwd0 + 1)
    q, k, v = (qkv.detach()[:, :, i] for i in range(3))
    scale = d ** -0.5
    want_out, want_lse = _ref_fwd(q, k, v, True, scale)
    _assert_close(out, want_out, FLASH_TOL["bfloat16"], "out")
    saved_out, saved_lse = fa.flash_fwd(q, k, v, True, scale)
    want = _ref_bwd(q, k, v, saved_out, saved_lse, do, True, scale)
    for i, (name, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        _assert_close(dqkv[:, :, i], w, FLASH_TOL["bfloat16"], name)


@pytest.mark.cuda
def test_flash_bwd_route_rule():
    """K2 for sq == sk with sq*d <= 8192*128, K3 otherwise: a short
    square case, sq < sk, and a square case past the length cap."""
    _need_hopper()
    cases = [((1, 128, 128, 2, 64), "fused"), ((1, 64, 128, 2, 64), "split"),
             ((1, 4160, 4160, 1, 256), "split")]
    for (b, sq, sk, h, d), kernel in cases:
        q, k, v, do = _flash_inputs(b, sq, sk, h, d, torch.bfloat16, seed=3)
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        counts = (fa.flash_bwd_fused.launches, fa.flash_bwd_split.launches)
        got = fa.flash_bwd(q, k, v, out, lse, do, True, scale)
        torch.cuda.synchronize()
        grew = (fa.flash_bwd_fused.launches - counts[0],
                fa.flash_bwd_split.launches - counts[1])
        assert grew == ((1, 0) if kernel == "fused" else (0, 1)), (sq, sk, d)
        want = _ref_bwd(q, k, v, out, lse, do, True, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _assert_close(g, w, FLASH_TOL["bfloat16"], name)


# K2's and K3's wgmma + TMA route (bf16, head_dim 64 and 128) on q/k/v
# sliced out of one fused [b, s, 3, h, d] projection, as the training path
# passes them, and on the plain forward's out (a strided view) and lse:
# every WGMMA_SHAPES case for K3, the square ones for K2.
WGMMA_BWD_CASES = [(shape, kernel) for shape in sorted(WGMMA_SHAPES)
                   for kernel in ("fused", "split")
                   if kernel == "split" or
                   WGMMA_SHAPES[shape][1] == WGMMA_SHAPES[shape][2]]


def _fused_qkv_bwd_inputs(b, sq, sk, h, d, causal, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, sk, 3, h, d, generator=g, device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if sq != sk:
        q = torch.randn(b, sq, 3, h, d, generator=g,
                        device="cuda").bfloat16()[:, :, 0]
    do = torch.randn(b, sq, h, d, generator=g, device="cuda").bfloat16()
    scale = d ** -0.5
    out, lse = _ref_fwd(q, k, v, causal, scale)
    return q, k, v, out, lse, do, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", WGMMA_BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_on_fused_qkv_views(d, causal, shape, kernel):
    _need_hopper()
    b, sq, sk, h = WGMMA_SHAPES[shape]
    q, k, v, out, lse, do, scale = _fused_qkv_bwd_inputs(
        b, sq, sk, h, d, causal, seed=d + sq + causal)
    fn = fa.flash_bwd_fused if kernel == "fused" else fa.flash_bwd_split
    before = fn.launches
    got = fn(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _ref_bwd(q, k, v, out, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _assert_close(g, w, FLASH_TOL["bfloat16"], "%s %s d %d causal %d %s"
                      % (kernel, name, d, causal, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_is_deterministic_where_it_should_be(d):
    """K3 has no atomics: two launches give the same bits. K2 adds dq
    with atomics (its last bits may change), but its dk and dv are each
    summed by one warpgroup in a fixed order."""
    _need_hopper()
    q, k, v, out, lse, do, scale = _fused_qkv_bwd_inputs(
        2, 1000, 1000, 3, d, True, seed=5)
    split = [fa.flash_bwd_split(q, k, v, out, lse, do, True, scale)
             for _ in range(2)]
    fused = [fa.flash_bwd_fused(q, k, v, out, lse, do, True, scale)
             for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*split):
        assert torch.equal(a, b_)
    for a, b_ in zip(fused[0][1:], fused[1][1:]):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_preprocess_matches_delta_ref(dtype, d):
    """The backward's pre-pass: delta against its plain formula (f32 sums
    of exact products, another order: 1e-5), lse2 = lse * log2(e) the
    same f32 multiply; on a strided out, with masked rows' lse."""
    _need_hopper()
    dt = getattr(torch, dtype)
    b, s, h = 2, 200, 3
    g = torch.Generator(device="cuda").manual_seed(6)
    outs = torch.randn(b, s, 2, h, d, generator=g, device="cuda").to(dt)
    out = outs[:, :, 1]
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    lse = torch.randn(b, h, s, generator=g, device="cuda") * 4
    lse[:, :, :3] = fa.NEG_INF
    before = fa.bwd_preprocess.launches
    delta, lse2 = fa.bwd_preprocess(out, do, lse)
    torch.cuda.synchronize()
    assert fa.bwd_preprocess.launches == before + 1
    torch.testing.assert_close(delta, fa.delta_ref(out, do), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(lse2, lse * fa.LOG2E, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
              fa.flash_bwd_split.launches)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 64, torch.float16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, True, 0.125)
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do, True, 0.125)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, True, 96 ** -0.5)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do, True, 96 ** -0.5)
    # the bf16 head_dim 64 / 128 route (K2 and K3 on TMA + wgmma) and its
    # pre-pass: a d stride other than 1, a misaligned view, an lse of
    # another shape or type, an fp16 out: raised, never another kernel
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 128, torch.bfloat16)
    pre = fa.bwd_preprocess.launches
    wide = torch.zeros(1, 64, 2, 256, device="cuda").bfloat16()
    for fn in (fa.flash_bwd_fused, fa.flash_bwd_split):
        with pytest.raises(ValueError):
            fn(q, k, v, q, lse, wide[..., ::2], True, 128 ** -0.5)
        with pytest.raises(ValueError):
            fn(q, k, v, q, lse, wide[..., 4:132], True, 128 ** -0.5)
        with pytest.raises(ValueError):
            fn(q, k, v, q, lse[:, :, :32], do, True, 128 ** -0.5)
        with pytest.raises(ValueError):
            fn(q, k, v, q, lse.double(), do, True, 128 ** -0.5)
    with pytest.raises(ValueError):
        fa.bwd_preprocess(q.half(), do.half(), lse)
    assert fa.bwd_preprocess.launches == pre
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
            fa.flash_bwd_split.launches) == counts


# ------------------------------------------------------------------ K6
# name -> (context_lens, n_heads, n_kv, tables): one query token a row.
# tables: False, a table a row; True, every row one table (an off-layout
# prefill chunk: rows of one sequence, each one key longer, padding rows
# of length 0 with garbage tables); "tails", one table whose slots past
# each row's own pages hold garbage ids of that row's (the rows share
# pages only over what each sees); "two", rows alternating between two
# tables (a 16-row tile the kernel must not share). "long" rows and
# "prefill_long" (one shared tile) span several of the kernel's key splits
# (128 keys or more, chosen per call; see paged_attention.decode_split);
# "short_chunk" is a prefill chunk of one tile (12 rows), which shares.
DECODE_MIXES = {
    "decode": ([9, 33, 0, 17, 70, 0], 4, 4, False),
    "prefill": (list(range(20, 41)) + [0] * 5, 4, 4, True),
    "short": ([1, 5, 15, 3, 8], 4, 4, False),
    "long": ([1000, 257, 0, 513], 4, 4, False),
    "gqa2": ([22, 0, 31, 64], 4, 2, False),
    "gqa4": ([40, 300, 0, 7], 8, 2, False),
    "prefill_tails": (list(range(30, 50)) + [0] * 4, 4, 4, "tails"),
    "two_tables": (list(range(40, 56)), 4, 4, "two"),
    "empty_in_tile": ([20, 0, 22, 23, 0, 0, 26, 27, 28, 0, 30, 31, 0, 33,
                       34, 0, 36], 4, 4, True),
    "prefill_long": (list(range(300, 331)) + [0] * 3, 4, 4, True),
    "gqa2_tails": (list(range(50, 70)), 4, 2, "tails"),
    "short_chunk": (list(range(5, 17)), 4, 4, True),
}


def _decode_setup(context_lens, n_heads, n_kv, shared=False, d=32, page=16,
                  seed=0):
    """q [rows, heads, d], f32 pools, block tables and lengths for K6:
    shuffled page ids; each row's unused block-table tail (all of an
    empty row's) holds out-of-range ids, which both sides clamp. With
    ``shared`` (``tables`` of DECODE_MIXES) every row reads the same block
    table (True: garbage only in an empty row's; "tails": in every row's
    tail, each row its own), or ("two") rows alternate between two."""
    rng = np.random.RandomState(seed)
    n_rows = len(context_lens)
    P = -(-max(context_lens) // page) + 1
    n_tables = {False: n_rows, "two": 2}.get(shared, 1)
    total_pages = n_tables * P + 1
    q = rng.randn(n_rows, n_heads, d).astype(np.float32)
    kp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    vp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    bt = (1 + rng.permutation(n_tables * P)).reshape(n_tables, P)
    bt = bt[np.arange(n_rows) % n_tables].astype(np.int32)
    for r, c in enumerate(context_lens):
        if shared is not True or c == 0:
            bt[r, -(-c // page):] = [-3 - r, total_pages + 7 + r][r % 2]
    cl = np.asarray(context_lens, np.int32)
    return q, kp, vp, bt, cl


def _decode_cuda(arrays, dtype):
    q, kp, vp, bt, cl = [torch.from_numpy(a).cuda() for a in arrays]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), bt, cl


def _decode_counts():
    return (tpa.paged_attention.launches, tpa.paged_attention.launches_q8,
            tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", sorted(DECODE_MIXES))
def test_decode_kernel_matches_ref(mix, dtype):
    """K6 over fp pools; tolerances as K4's (online against direct
    softmax; in bf16 one rounding of an f32 result)."""
    _need_hopper()
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    case = _decode_cuda(_decode_setup(lens, nh, nkv, shared, seed=41),
                        getattr(torch, dtype))
    before = _decode_counts()
    got = tpa.paged_attention(*case)
    torch.cuda.synchronize()
    assert _decode_counts() == (before[0] + 1,) + before[1:]
    want = tpa.paged_attention_ref(*case)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[case[4] == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", sorted(DECODE_MIXES))
def test_decode_q8_kernel_matches_ref(mix, dtype):
    """K6 over int8 pools against its plain version, row by row (as K5)."""
    _need_hopper()
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    q, kp, vp, bt, cl = _decode_cuda(
        _decode_setup(lens, nh, nkv, shared, seed=42), torch.float32)
    case = (q.to(getattr(torch, dtype)), tpa.quantize_kv_pages(kp),
            tpa.quantize_kv_pages(vp), bt, cl)
    before = _decode_counts()
    got = tpa.paged_attention(*case)
    torch.cuda.synchronize()
    assert _decode_counts() == (before[0], before[1] + 1) + before[2:]
    want = tpa.paged_attention_ref(*case)
    live = cl > 0
    _assert_close(got[live], want[live], Q8_TOL[dtype], mix)
    assert (got[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
def test_decode_kernel_groups_dims_pages(group, d, page):
    """The long mix at 16 query heads over 16, 4, 2 and 1 kv heads, bf16,
    over a bf16 pool and over its int8 quantization."""
    _need_hopper()
    lens = DECODE_MIXES["long"][0]
    q, kp, vp, bt, cl = _decode_cuda(
        _decode_setup(lens, 16, 16 // group, d=d, page=page, seed=43),
        torch.float32)
    what = "group %d d %d page %d" % (group, d, page)
    fp = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt, cl)
    torch.testing.assert_close(tpa.paged_attention(*fp).float(),
                               tpa.paged_attention_ref(*fp).float(),
                               rtol=2e-2, atol=2e-2, msg=what)
    q8 = (q.bfloat16(), tpa.quantize_kv_pages(kp),
          tpa.quantize_kv_pages(vp), bt, cl)
    got, want = tpa.paged_attention(*q8), tpa.paged_attention_ref(*q8)
    live = cl > 0
    _assert_close(got[live], want[live], Q8_TOL["bfloat16"], what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_q8_kernel_matches_fp_kernel_on_the_same_values(dtype):
    """K6 over int8 pages against K6 over the pool they decode to: with
    power-of-two scales every decoded value is exact in bf16 too, so both
    routes run the same f32 arithmetic on the same values, bit for bit
    (as K5 against K4)."""
    _need_hopper()
    dt = getattr(torch, dtype)
    lens, nh, nkv, _ = DECODE_MIXES["gqa2"]
    q, kp, vp, bt, cl = _decode_cuda(_decode_setup(lens, nh, nkv, seed=44),
                                     torch.float32)
    g = torch.Generator(device="cuda").manual_seed(6)

    def pool(shape):
        q8 = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        e = torch.randint(-9, -3, shape[:3], generator=g, device="cuda")
        return {"q8": q8, "s": torch.exp2(e.float())}

    k8, v8 = pool(tuple(kp.shape)), pool(tuple(vp.shape))
    kf, vf = (tpa._dequant(p["q8"], p["s"]).to(dt) for p in (k8, v8))
    got = tpa.paged_attention(q.to(dt), k8, v8, bt, cl)
    want = tpa.paged_attention(q.to(dt), kf, vf, bt, cl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("mix", ["long", "prefill_long", "prefill_tails"])
def test_decode_kernel_is_deterministic(mix, pool):
    """Two launches on the same inputs give the same bits: the warps and
    the key splits are merged in a fixed order, and whether a tile's rows
    share one read depends on the inputs alone."""
    _need_hopper()
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    q, kp, vp, bt, cl = _decode_cuda(
        _decode_setup(lens, nh, nkv, shared, seed=45), torch.float32)
    if pool == "int8":
        kp, vp = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    case = (q.bfloat16(), kp, vp, bt, cl)
    assert torch.equal(tpa.paged_attention(*case),
                       tpa.paged_attention(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_decode_kernel_in_a_cuda_graph(pool):
    """One call captured in a CUDA graph, replayed after new context
    lengths are written into the captured tensor, matches the plain
    version on the new lengths: the workspace and the split are sized
    from shapes alone and nothing waits on the host."""
    _need_hopper()
    lens = [1000, 700, 0, 513, 40, 999, 1, 300]
    q, kp, vp, bt, cl = _decode_cuda(
        _decode_setup(lens, 8, 4, seed=46), torch.float32)
    if pool == "int8":
        kp, vp = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    q = q.bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: build, bind, allocate
        tpa.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_attention(q, kp, vp, bt, cl)
    for new in ([5, 1000, 300, 0, 999, 2, 640, 129],
                [0, 0, 1000, 1000, 17, 256, 257, 0]):
        cl.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = tpa.paged_attention_ref(q, kp, vp, bt, cl)
        live = cl > 0
        _assert_close(out[live], want[live], Q8_TOL["bfloat16"],
                      "graph %s %s" % (pool, new))
        assert (out[~live] == 0).all()


@pytest.mark.cuda
def test_decode_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    lens, nh, nkv, _ = DECODE_MIXES["decode"]
    case = _decode_cuda(_decode_setup(lens, nh, nkv), torch.float32)
    q, kp, vp, bt, cl = case
    before = _decode_counts()
    bad = {
        "fp16": (q.half(), kp.half(), vp.half(), bt, cl),
        "mixed_types": (q.bfloat16(), kp, vp, bt, cl),
        "int64_lens": (q, kp, vp, bt, cl.long()),
        "rows": (q[:-1].contiguous(), kp, vp, bt, cl),
        "strided_q": (q.transpose(0, 1).contiguous().transpose(0, 1), kp,
                      vp, bt, cl),
        "group_32": (torch.zeros(6, 32, 32, device="cuda"), kp[:1], vp[:1],
                     bt, cl),
        "d40_q8": _decode_cuda(_decode_setup(lens, nh, nkv, d=40),
                               torch.float32),
    }
    k8, v8 = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    bad["fp16_q8"] = (q.half(), k8, v8, bt, cl)
    bad["mixed_pools"] = (q, k8, vp, bt, cl)
    d40 = bad["d40_q8"]
    bad["d40_q8"] = (d40[0], tpa.quantize_kv_pages(d40[1]),
                     tpa.quantize_kv_pages(d40[2]), *d40[3:])
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tpa.paged_attention(*args)
    assert _decode_counts() == before


# ------------------------------------------------------------------ K8
# K8 against its plain version. f32: rtol = atol = 2e-4 (FFMA against an
# f32 matmul summed in another order). bf16, row by row (``_row_err``):
# both sum the same bf16 products in f32 and round once, so they differ
# where the two f32 sums straddle a bf16 rounding boundary: one bf16 ulp,
# at most 2^-7 of a row's largest value, which in a Gaussian row of a few
# thousand values is up to ~5x the row's RMS: 0.04 of the RMS (read on an
# H100 at 0.0002-0.0289, bench.py's ffn2 the largest). A column or K tile
# left out reads 0.3 or more. With row counts (``rows``) the same limits
# hold against the plain version with the same counts; rows past a count
# must be exactly zero, and a routed map's own counts must not change the
# output at all.
GMM_ROW_TOL = 4e-2
GMM_F32_TOL = dict(rtol=2e-4, atol=2e-4)

# name -> (K, N, block map): a list of expert ids, or (S, E, top-k, experts
# that receive tokens) routed through sort_dispatch
GMM_CASES = {
    "n768": (64, 768, [0, 1, 2, 3]),
    "ragged_n": (96, 200, [1, 0, 2]),
    "k_tail": (200, 136, [2, 2, 0, 1]),
    "non_monotone": (64, 256, [2, 0, 3, 3, 1, 0]),
    "out_of_range_ids": (64, 128, [5, -2, 1, 4]),
    "all_on_one_expert": (128, 256, (300, 4, 1, [2])),
    "empty_experts": (128, 256, (300, 8, 2, [1, 6])),
    "routed": (256, 512, (700, 8, 2, None)),
}


def _gmm_case(name, dtype, seed=0):
    """xp, w, block_gid on the card; a routed map comes from a real
    sort_dispatch whose pad rows are zero."""
    kdim, n, spec = GMM_CASES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if isinstance(spec, list):
        e = 4
        gid = torch.tensor(spec, dtype=torch.int32, device="cuda")
        xp = torch.randn(len(spec) * tmd.BM, kdim, generator=g,
                         device="cuda")
    else:
        s, e, k, live = spec
        logits = torch.randn(s, e, generator=g, device="cuda")
        if live is not None:
            mask = torch.full((e,), -30.0, device="cuda")
            mask[live] = 0.0
            logits = logits + mask
        x = torch.randn(s, kdim, generator=g, device="cuda")
        d = tmd.sort_dispatch(x, torch.softmax(logits, -1), k)
        xp, gid = d["xp"], d["block_gid"]
    w = torch.randn(e, kdim, n, generator=g, device="cuda") / kdim ** 0.5
    return xp.to(dtype).contiguous(), w.to(dtype), gid


def _check_gmm(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **GMM_F32_TOL)
    else:
        _assert_close(got, want, GMM_ROW_TOL, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_gmm_kernel_matches_ref(name, dtype):
    _need_hopper()
    dt = getattr(torch, dtype)
    xp, w, gid = _gmm_case(name, dt)
    before = tmd.grouped_matmul.launches
    got = tmd.grouped_matmul(xp, w, gid)
    torch.cuda.synchronize()
    assert tmd.grouped_matmul.launches == before + 1
    assert got.shape == (xp.shape[0], w.shape[-1]) and got.dtype == dt
    _check_gmm(got, tmd.grouped_matmul_ref(xp, w, gid), dt,
               "K8 %s %s" % (name, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("gemm", ["ffn1", "ffn2"])
def test_gmm_kernel_bench_shape(gemm):
    """bench.py's MoE step: 8192 tokens x 2048, 8 experts, SwiGLU dff
    2816, top-2 (P = 17408), bf16: K 2048 x N 5632, then K 2816 x N
    2048."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(0)
    s, m, dff, e = 8192, 2048, 2816, 8
    kdim, n = (m, 2 * dff) if gemm == "ffn1" else (dff, m)
    x = torch.randn(s, kdim, generator=g, device="cuda").bfloat16()
    probs = torch.softmax(torch.randn(s, e, generator=g, device="cuda"), -1)
    d = tmd.sort_dispatch(x, probs, 2)
    w = (0.02 * torch.randn(e, kdim, n, generator=g, device="cuda")) \
        .bfloat16()
    got = tmd.grouped_matmul(d["xp"], w, d["block_gid"])
    assert got.shape == (17408, n)
    _assert_close(got, tmd.grouped_matmul_ref(d["xp"], w, d["block_gid"]),
                  GMM_ROW_TOL, "K8 bench %s" % gemm)


@pytest.mark.cuda
def test_gmm_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    xp, w, gid = _gmm_case("non_monotone", torch.float32)
    before = tmd.grouped_matmul.launches
    bad = {
        "fp16": (xp.half(), w.half(), gid),
        "mixed_types": (xp.bfloat16(), w, gid),
        "int64_ids": (xp, w, gid.long()),
        "ids_shape": (xp, w, gid[:-1]),
        "rows": (xp[:-8].contiguous(), w, gid),
        "k_not_8": (xp[:, :60].contiguous(), w[:, :60].contiguous(), gid),
        "n_not_8": (xp, w[..., :100].contiguous(), gid),
        "strided_w": (xp, w.transpose(1, 2).contiguous().transpose(1, 2),
                      gid),
        "cpu_ids": (xp, w, gid.cpu()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tmd.grouped_matmul(*args)
    counts = torch.full_like(gid, tmd.BM)
    for rows in (counts.long(), counts[:-1], counts.cpu()):
        with pytest.raises(ValueError, match="rows"):
            tmd.grouped_matmul(xp, w, gid, rows=rows)
    assert tmd.grouped_matmul.launches == before


@pytest.mark.cuda
def test_gmm_wrapper_raises_under_grad():
    """The kernel returns no gradient, so it refuses an input that asks
    for one rather than hand back a detached result."""
    _need_hopper()
    xp, w, gid = _gmm_case("non_monotone", torch.float32)
    with pytest.raises(ValueError, match="gradient"):
        tmd.grouped_matmul(xp.requires_grad_(), w, gid)
    with torch.no_grad():
        tmd.grouped_matmul(xp, w, gid)


@pytest.mark.cuda
def test_moe_ffn_sorted_gradients_on_the_card():
    """The functional layer's autograd Function (forward on K8, backward
    the plain version's vjp) against autograd through the plain version
    on the same CUDA tensors, f32, with biases."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(3)
    s, m, e, dff = 300, 64, 4, 96
    leaves = [torch.randn(*shape, generator=g, device="cuda") * scale
              for shape, scale in (((s, m), 1.0), ((s, e), 1.0),
                                   ((e, m, 2 * dff), 0.2),
                                   ((e, dff, m), 0.2))]
    leaves[1] = torch.softmax(leaves[1], -1)
    b1 = 0.1 * torch.randn(e, 2 * dff, generator=g, device="cuda")
    b2 = 0.1 * torch.randn(e, m, generator=g, device="cuda")
    cot = torch.randn(s, m, generator=g, device="cuda")

    def run():
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        out = fmd.moe_ffn_sorted(*ts, k=2, b1=b1, b2=b2)
        (out * cot).sum().backward()
        return [out.detach()] + [t.grad for t in ts]

    before = tmd.grouped_matmul.launches
    got = run()
    assert tmd.grouped_matmul.launches == before + 2
    kernel = fmd.grouped_matmul
    fmd.grouped_matmul = tmd.grouped_matmul_ref
    try:
        want = run()
    finally:
        fmd.grouped_matmul = kernel
    assert tmd.grouped_matmul.launches == before + 2
    for name, a, b in zip(("out", "x", "probs", "w1", "w2"), got, want):
        torch.testing.assert_close(a, b, msg=name, **GMM_F32_TOL)


def _gmm_rows(name, xp, gid, seed=1):
    """Row counts for a K8 case: a routed map's own (its rows that came
    from a token; sort_dispatch puts them first in a block and zeroes
    the rest); a listed map's drawn from {0, 1, 63, 64, 65, 127, 128}
    and beyond (clamped), so that some blocks and 64-row halves hold no
    real row."""
    if not isinstance(GMM_CASES[name][2], list):
        return (xp != 0).any(-1).view(-1, tmd.BM).sum(-1).to(torch.int32)
    picks = torch.tensor([0, 1, 63, 64, 65, 127, 128, 200, -3],
                         dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    i = torch.randint(0, picks.numel(), gid.shape, generator=g,
                      device="cuda")
    rows = picks[i]
    rows[0] = 0                          # a block of padding only
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_gmm_kernel_row_counts(name, dtype):
    """K8 with ``rows``: rows past each block's count are zero, against
    the plain version with the same counts; on a routed map with its
    own counts (pad rows zero) equal to the call without counts."""
    _need_hopper()
    dt = getattr(torch, dtype)
    xp, w, gid = _gmm_case(name, dt)
    rows = _gmm_rows(name, xp, gid)
    before = tmd.grouped_matmul.launches
    got = tmd.grouped_matmul(xp, w, gid, rows=rows)
    torch.cuda.synchronize()
    assert tmd.grouped_matmul.launches == before + 1
    want = tmd.grouped_matmul_ref(xp, w, gid, rows=rows)
    _check_gmm(got, want, dt, "K8 %s %s rows" % (name, dtype))
    real = torch.arange(tmd.BM, device="cuda") < rows[:, None]
    assert not bool(got.view(-1, tmd.BM, got.shape[-1])[~real].any())
    if not isinstance(GMM_CASES[name][2], list):
        assert torch.equal(got, tmd.grouped_matmul(xp, w, gid))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [4096, 4100])
def test_gmm_kernel_row_counts_many_blocks(n_blocks):
    """bf16 with counts at the most row blocks whose walk the kernel
    orders (4096) and past it (the blocks' own order): every third block
    holds only padding."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(6)
    xp = torch.randn(n_blocks * tmd.BM, 64, generator=g,
                     device="cuda").bfloat16()
    w = (torch.randn(4, 64, 72, generator=g, device="cuda") / 8).bfloat16()
    gid = torch.randint(0, 4, (n_blocks,), generator=g, device="cuda",
                        dtype=torch.int32)
    rows = torch.randint(1, tmd.BM + 1, (n_blocks,), generator=g,
                         device="cuda", dtype=torch.int32)
    rows[::3] = 0
    got = tmd.grouped_matmul(xp, w, gid, rows=rows)
    _assert_close(got, tmd.grouped_matmul_ref(xp, w, gid, rows=rows),
                  GMM_ROW_TOL, "K8 %d blocks rows" % n_blocks)


@pytest.mark.cuda
def test_gmm_block_rows_match_the_dispatch():
    """``block_rows`` of a real dispatch on the card counts each block's
    rows that came from a token: the rows of xp that are not the zero
    pad row (tokens drawn with no zero row)."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(4)
    for s, e, k in ((8, 8, 2), (300, 8, 2), (2048, 8, 2)):
        x = torch.randn(s, 64, generator=g, device="cuda") + 10.0
        probs = torch.softmax(torch.randn(s, e, generator=g, device="cuda"),
                              -1)
        d = tmd.sort_dispatch(x, probs, k)
        rows = tmd.block_rows(d["block_gid"], d["group_sizes"],
                              d["padded_sizes"])
        assert rows.dtype == torch.int32 and rows.device == x.device
        real = (d["xp"] != 0).any(-1).view(-1, tmd.BM).sum(-1)
        assert torch.equal(rows, real.to(torch.int32)), (s, rows, real)


@pytest.mark.cuda
@pytest.mark.parametrize("gemm", ["ffn1", "ffn2"])
def test_gmm_kernel_bench_shape_row_counts(gemm):
    """bench.py's two products with the dispatch's row counts: equal to
    the call without them (pad rows are zero), and within the row limit
    of the plain version."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(0)
    s, m, dff, e = 8192, 2048, 2816, 8
    kdim, n = (m, 2 * dff) if gemm == "ffn1" else (dff, m)
    x = torch.randn(s, kdim, generator=g, device="cuda").bfloat16()
    probs = torch.softmax(torch.randn(s, e, generator=g, device="cuda"), -1)
    d = tmd.sort_dispatch(x, probs, 2)
    rows = tmd.block_rows(d["block_gid"], d["group_sizes"],
                          d["padded_sizes"])
    w = (0.02 * torch.randn(e, kdim, n, generator=g, device="cuda")) \
        .bfloat16()
    got = tmd.grouped_matmul(d["xp"], w, d["block_gid"], rows=rows)
    assert torch.equal(got, tmd.grouped_matmul(d["xp"], w, d["block_gid"]))
    _assert_close(got, tmd.grouped_matmul_ref(d["xp"], w, d["block_gid"],
                                              rows=rows),
                  GMM_ROW_TOL, "K8 bench %s rows" % gemm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["routed", "non_monotone", "k_tail"])
def test_gmm_kernel_is_deterministic(name, dtype):
    """No split K, no atomics: two launches give the same bits, with and
    without counts."""
    _need_hopper()
    xp, w, gid = _gmm_case(name, getattr(torch, dtype))
    rows = _gmm_rows(name, xp, gid)
    for r in (None, rows):
        a = tmd.grouped_matmul(xp, w, gid, rows=r)
        b = tmd.grouped_matmul(xp, w, gid, rows=r)
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_gmm_function_with_row_counts_gradients():
    """The functional layer's autograd Function with ``rows`` (forward
    on K8, backward the plain version's vjp) against autograd through
    the plain version with the same counts, f32."""
    _need_hopper()
    xp, w, gid = _gmm_case("non_monotone", torch.float32)
    rows = _gmm_rows("non_monotone", xp, gid)
    cot = torch.randn(xp.shape[0], w.shape[-1], device="cuda")
    grads = []
    for fn in (fmd.grouped_matmul, tmd.grouped_matmul_ref):
        a = xp.detach().clone().requires_grad_()
        b = w.detach().clone().requires_grad_()
        before = tmd.grouped_matmul.launches
        out = fn(a, b, gid, rows=rows)
        assert tmd.grouped_matmul.launches == before + \
            (fn is fmd.grouped_matmul)
        (out * cot).sum().backward()
        grads.append((out.detach(), a.grad, b.grad))
    for what, g, r in zip(("out", "dxp", "dw"), *grads):
        torch.testing.assert_close(g, r, msg=what, **GMM_F32_TOL)


# ------------------------------------------------------------ K9, K10
# K9's product against its plain version (f32 sums of the same products,
# rounded once): f32 within rtol = atol = 2e-4 and bf16 within 4e-2 of a
# row's RMS, K8's limits (the same tile code). K9's copy and K10 are pure
# data movement: bit-exact.
RING_F32_TOL = dict(rtol=2e-4, atol=2e-4)
RING_ROW_TOL = 4e-2

# name -> (t, k, n, leading dims of buf after t). "mp2" and "mp4" are a
# rank's block at bench.py's TP shape (T 16384, K 4096, N 1024) at mp 2
# and 4: the bf16 kernel's 128 x 256 and 128 x 64 tiles, the f32 kernel's
# 128 x 128 and 64 x 128.
RING_CASES = {
    "tiles": (256, 256, 128, ()),
    "n200": (128, 64, 200, ()),
    "k200": (130, 200, 64, ()),
    "3d": (16, 64, 64, (6,)),
    "one_row": (1, 8, 8, ()),
    "t100": (100, 64, 72, ()),
    "mp2": (8192, 4096, 512, ()),
    "mp4": (4096, 4096, 256, ()),
}


def _rings(size=2):
    """Rings of ``size`` ranks decided here, never at import: all on card
    0, and one rank a card when as many cards with peer access are
    present."""
    rings = [Ring(["cuda:0"] * size)]
    n = torch.cuda.device_count()
    if n >= size and all(torch.cuda.can_device_access_peer(a, b)
                         for a in range(size) for b in range(size)
                         if a != b):
        rings.append(Ring(["cuda:%d" % r for r in range(size)]))
    return rings


def _per_rank(ring, shape, dtype, g, scale=1.0):
    return [(scale * torch.randn(*shape, generator=g, device="cuda"))
            .to(d, dtype) for d in ring.devices]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_mm_step_matches_ref(name, dtype):
    _need_hopper()
    dt = getattr(torch, dtype)
    t, k, n, lead = RING_CASES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    for ring in _rings():
        bufs = _per_rank(ring, (t,) + lead + (k,), dt, g)
        ws = _per_rank(ring, (k, n), dt, g, 0.05)
        before = kring.mm_step.launches
        parts, nexts = kring.mm_step(bufs, ws, ring)
        want_p, want_n = kring.mm_step_ref(bufs, ws, ring)
        torch.cuda.synchronize()
        assert kring.mm_step.launches == before + ring.size
        for r in range(ring.size):
            assert nexts[r].device == ring.device(r)
            assert torch.equal(nexts[r], want_n[r]), (name, r)
            assert parts[r].shape == (t,) + lead + (n,)
            if dt == torch.float32:
                torch.testing.assert_close(parts[r], want_p[r],
                                           **RING_F32_TOL)
            else:
                _assert_close(parts[r], want_p[r], RING_ROW_TOL,
                              "K9 %s rank %d %s" % (name, r, ring))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_mm_step_is_deterministic_and_tiled(dtype):
    """Two launches on the same inputs give the same bits (no split K, no
    atomics), and the tile follows the item count: at mp 2 the bf16 kernel
    takes 128 x 256 tiles and f32 128 x 128, at mp 4 128 x 64 and 64 x 128."""
    _need_hopper()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    ring = Ring(["cuda:0"] * 2)
    want = {"mp2": (128, 256) if dtype == "bfloat16" else (128, 128),
            "mp4": (128, 64) if dtype == "bfloat16" else (64, 128)}
    for name in ("mp2", "mp4"):
        t, k, n, _ = RING_CASES[name]
        plan = kring.mm_step_plan(t, k, n, dt)
        print(name, dtype, plan)
        assert plan["tile"] == want[name]
        bufs = _per_rank(ring, (t, k), dt, g)
        ws = _per_rank(ring, (k, n), dt, g, 0.05)
        a = kring.mm_step(bufs, ws, ring)
        b = kring.mm_step(bufs, ws, ring)
        for r in range(2):
            assert torch.equal(a[0][r], b[0][r]), (name, r)
            assert torch.equal(a[1][r], bufs[r - 1]), (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1024, 2048), (1001,), (3, 333)])
@pytest.mark.parametrize("size", [2, 3])
def test_ring_shift_matches_ref(size, shape, dtype):
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(1)
    for ring in _rings(size):
        xs = _per_rank(ring, shape, getattr(torch, dtype), g)
        for step in range(1, size):
            before = kring.shift.launches
            got = kring.shift(xs, ring, step)
            want = ring.shift_ref(xs, step)
            torch.cuda.synchronize()
            assert kring.shift.launches == before + size
            for r in range(size):
                assert got[r].device == ring.device(r)
                assert torch.equal(got[r], want[r]), (shape, step, r)


@pytest.mark.cuda
def test_ring_wrappers_raise_instead_of_falling_back():
    _need_hopper()
    ring = Ring(["cuda:0"] * 2)
    g = torch.Generator(device="cuda").manual_seed(2)
    bufs = _per_rank(ring, (64, 32), torch.float32, g)
    ws = _per_rank(ring, (32, 16), torch.float32, g)
    counts = (kring.mm_step.launches, kring.shift.launches)
    bad = {
        "fp16": ([b.half() for b in bufs], [w.half() for w in ws]),
        "mixed_types": ([b.bfloat16() for b in bufs], ws),
        "one_rank": (bufs[:1], ws[:1]),
        "ranks_differ": ([bufs[0], bufs[1][:32]], ws),
        "strided_buf": ([b.t().contiguous().t() for b in bufs], ws),
        "k_not_8": ([b[:, :30].contiguous() for b in bufs],
                    [w[:30].contiguous() for w in ws]),
        "n_not_8": (bufs, [w[:, :12].contiguous() for w in ws]),
        "w_3d": (bufs, [w[None] for w in ws]),
        "cpu_w": (bufs, [w.cpu() for w in ws]),
    }
    for name, (b, w) in bad.items():
        with pytest.raises(ValueError):
            kring.mm_step(b, w, ring)
    with pytest.raises(ValueError):
        kring.shift([b.t() for b in bufs], ring)
    with pytest.raises(ValueError):
        kring.shift([bufs[0], bufs[1][:32]], ring)
    with pytest.raises(ValueError, match="gradient"):
        kring.mm_step([b.requires_grad_() for b in bufs], ws, ring)
    with pytest.raises(ValueError, match="gradient"):
        kring.shift(bufs, ring)
    assert (kring.mm_step.launches, kring.shift.launches) == counts
    rings = _rings()
    if len(rings) > 1:
        with pytest.raises(ValueError, match="rank's device"):
            kring.shift([b.detach() for b in bufs], rings[1])


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 4])
def test_all_gather_matmul_on_the_card(size):
    """The TP primitives on a CUDA ring against their serial compositions:
    K9 launches size x (size - 1) times in the all-gather-matmul forward
    and never in a backward or in matmul_reduce_scatter."""
    _need_hopper()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(8 * size, 6, 64, generator=g, device="cuda")
    w = 0.05 * torch.randn(64, 16 * size, generator=g, device="cuda")
    for ring in _rings(size):
        for fn in (tom.sharded_all_gather_matmul,
                   tom.sharded_matmul_reduce_scatter):
            res = []
            for off in (False, True):
                xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
                before = kring.mm_step.launches
                with tom.override(tp_overlap="off" if off else "pallas"):
                    out = fn(xg, wg, ring=ring)
                    fwd = kring.mm_step.launches - before
                    dx, dw = torch.autograd.grad((out * out).sum(), [xg, wg])
                want = size * (size - 1) if fn is \
                    tom.sharded_all_gather_matmul and not off else 0
                assert fwd == want and \
                    kring.mm_step.launches - before == want, (fn, off)
                res.append((out, dx, dw))
            for a, b in zip(*res):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ring_shift_autograd_on_the_card():
    _need_hopper()
    for ring in _rings(2):
        xs = [torch.full((4, 8), float(r), device=d).requires_grad_()
              for r, d in enumerate(ring.devices)]
        before = kring.shift.launches
        out = ring_shift(xs, ring)
        assert kring.shift.launches == before + 2
        gs = [torch.full((4, 8), 10.0 + r, device=d)
              for r, d in enumerate(ring.devices)]
        grads = torch.autograd.grad(out, xs, gs)
        torch.cuda.synchronize()
        assert kring.shift.launches == before + 4
        for r, d in enumerate(ring.devices):
            assert out[r].device == d and grads[r].device == d
            # forward: rank r holds rank r - 1's tensor; backward: rank r
            # gets rank r + 1's gradient (the shift by size - 1)
            assert torch.equal(out[r], xs[(r - 1) % 2].detach().to(d))
            assert torch.equal(grads[r], gs[(r + 1) % 2].to(d))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_on_the_card_matches_the_cpu_ring(S):
    """A tiny CompiledPipeline on a CUDA ring against the same on a CPU
    ring: losses and parameters after 2 SGD steps; K10 launches
    S (M + S - 1) forward and S (M + S - 2) backward a step."""
    _need_hopper()
    from paddle_tpu_torch.models import pipeline_gpt

    M, lr = 4, 0.01
    blocks, extra, rng = pipeline_gpt.weights(2 * S, 32, 64, 8)
    stacked = pipeline_gpt.stack(blocks, S)
    ids = torch.from_numpy(rng.integers(0, 64, (M, 8)))
    labels = torch.from_numpy(rng.integers(0, 64, (M, 8)))
    stage_fn, pre_fn, loss_fn = pipeline_gpt.functions(4)
    for ring in _rings(S):
        pipes = [CompiledPipeline(stage_fn, stacked, loss_fn, S, M,
                                  optimizer=SGD(lr), extra_params=extra,
                                  pre_fn=pre_fn, devices=devs)
                 for devs in (ring, ["cpu"] * S)]
        for _ in range(2):
            before = kring.shift.launches
            got = pipes[0].step(ids, labels).item()
            torch.cuda.synchronize()
            assert kring.shift.launches - before == \
                S * (M + S - 1) + S * (M + S - 2)
            want = pipes[1].step(ids, labels).item()
            assert abs(got - want) <= 1e-5 * abs(want)
        for a, b in zip(pipes[0].params, pipes[1].params):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ------------------------------------------------- training paths: K1/K2, K7
@pytest.mark.cuda
def test_flash_at_llama_training_shape():
    """K1 and K2 where Llama-2 7B training runs them: b 2, s 4096, 32
    heads, d 128, causal, bf16 (s * d under K2's cap), against the plain
    versions one batch row at a time (their [h, s, s] f32 tiles)."""
    _need_hopper()
    b, s, h, d = 2, 4096, 32, 128
    q, k, v, do = _flash_inputs(b, s, s, h, d, torch.bfloat16, seed=9)
    scale = d ** -0.5
    assert fa.uses_fused_bwd(s, s, d)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    got = fa.flash_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    for i in range(b):
        row = slice(i, i + 1)
        want_out, want_lse = _ref_fwd(q[row], k[row], v[row], True, scale)
        _assert_close(out[row], want_out, FLASH_TOL["bfloat16"], "out")
        _assert_lse_close(lse[row], want_lse)
        want = _ref_bwd(q[row], k[row], v[row], out[row], lse[row], do[row],
                        True, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _assert_close(g[row], w, FLASH_TOL["bfloat16"], name)
        del want_out, want_lse, want
        torch.cuda.empty_cache()


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
def test_kernels_inside_checkpoint():
    """K7's ``_RowNorm`` and K1/K2 inside non-reentrant
    ``torch.utils.checkpoint``: the same output and grads as without it
    (K2 adds dq with atomics, so grads within 1e-2 relative L2; out and
    the norm's output bit for bit), K1 and K7 launched again by the
    recompute, K2 once either way."""
    _need_hopper()
    from torch.utils.checkpoint import checkpoint

    from paddle_tpu_torch.incubate.nn.functional import (
        fused_rms_norm, rms_norm, scaled_dot_product_attention)

    g = torch.Generator(device="cuda").manual_seed(11)
    b, s, h, d = 2, 512, 4, 64
    x0 = torch.randn(b, s, h * d, generator=g, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(h * d, generator=g, device="cuda")).bfloat16()
    wqkv = (0.05 * torch.randn(h * d, 3 * h * d, generator=g,
                               device="cuda")).bfloat16()

    def block(x, w, wqkv):
        qkv = (rms_norm(x, w, None, 1e-5) @ wqkv).reshape(b, s, 3, h, d)
        a = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], is_causal=True)
        y, x = fused_rms_norm(a.reshape(b, s, h * d), w, None, 1e-5,
                              residual=x)
        return y + x

    res = []
    for ckpt in (False, True):
        leaves = [t.detach().clone().requires_grad_() for t in (x0, w, wqkv)]
        counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
                  tn.rms_norm.launches)
        out = checkpoint(block, *leaves, use_reentrant=False) if ckpt \
            else block(*leaves)
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
        torch.cuda.synchronize()
        launched = tuple(a - b_ for a, b_ in zip(
            (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
             tn.rms_norm.launches), counts))
        assert launched == ((2, 1, 4) if ckpt else (1, 1, 2)), launched
        res.append((out, grads))
    assert torch.equal(res[0][0], res[1][0])
    for name, a, w_ in zip(("dx", "dw", "dwqkv"), res[1][1], res[0][1]):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_l2(a, w_) <= 1e-2, (name, _rel_l2(a, w_))


@pytest.mark.cuda
def test_llama_recompute_on_the_card():
    """A 2-layer Llama of head_dim 64 (GQA 4/2) in bf16 on the card, with
    and without recompute, the same weights: loss bit for bit, grads
    within 1e-2 relative L2 (K2's dq atomics), a step's launches K1 2L,
    K2 L, K3 0, K7 4L + 1 with recompute (L, L, 0, 2L + 1 without)."""
    _need_hopper()
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    L = 2
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=L, num_heads=4,
               num_kv_heads=2, max_position_embeddings=512,
               lm_ce_chunks=4)
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
    labels = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
    res = []
    for recompute in (False, True):
        m = LlamaForCausalLM(LlamaConfig(recompute=recompute, **cfg),
                             dtype=torch.bfloat16, seed=0)
        counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
                  fa.flash_bwd_split.launches, tn.rms_norm.launches)
        loss = m(ids, labels=labels)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        launched = tuple(a - b_ for a, b_ in zip(
            (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
             fa.flash_bwd_split.launches, tn.rms_norm.launches), counts))
        want = (2 * L, L, 0, 4 * L + 1) if recompute else (L, L, 0,
                                                           2 * L + 1)
        assert launched == want, (recompute, launched)
        res.append((loss, grads))
    assert torch.equal(res[0][0], res[1][0])
    for i, (a, w_) in enumerate(zip(res[1][1], res[0][1])):
        assert bool(torch.isfinite(a).all()), i
        assert _rel_l2(a, w_) <= 1e-2, (i, _rel_l2(a, w_))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_fused_moe_mlp_on_the_card_matches_the_cpu(factor):
    """MoE GPT's FFN (``fusion.fused_moe_mlp``) in f32 on the card
    against the same call on the CPU: identical routing slots from the
    same logits; y, aux and the grads of x and every weight no farther
    from an f64 run on the CPU than twice the CPU's f32 run, plus 1e-6
    (relative L2; TF32 off). The router's gradient holds terms that are
    zero in exact arithmetic (a token with one kept choice has the
    normalised gate g / g = 1), which each run computes as the rounding
    noise of two equal products: at capacity factor 0.25 the card's and
    the CPU's dgate read 0.0038 apart, so no fixed f32 limit fits."""
    _need_hopper()
    from paddle_tpu_torch.fusion.moe import fused_moe_mlp, gshard_top2

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(12)
        E, d, ffn, b, s = 8, 64, 96, 4, 128
        cap = max(4, int(factor * b * s * 2 / E))
        arrays = [rng.randn(b, s, d), 0.3 * rng.randn(d, E),
                  0.1 * rng.randn(E, d, ffn), 0.1 * rng.randn(E, ffn),
                  0.1 * rng.randn(E, ffn, d), 0.1 * rng.randn(E, d)]
        logits = arrays[0].reshape(-1, d) @ arrays[1]
        res, slots = {}, {}
        for dev, dt in (("cpu", torch.float64), ("cpu", torch.float32),
                        ("cuda", torch.float32)):
            ts = [torch.tensor(a, dtype=dt, device=dev).requires_grad_()
                  for a in arrays]
            y, aux = fused_moe_mlp(*ts, E, cap)
            grads = torch.autograd.grad((y ** 2).sum() + aux, ts)
            res[dev, dt] = [t.detach().cpu().double()
                            for t in (y, aux, *grads)]
            if dt == torch.float32:
                slots[dev] = [t.cpu() for t in gshard_top2(torch.tensor(
                    logits, dtype=dt, device=dev), E, cap)[:2]]
        assert all(torch.equal(a, b_) for a, b_ in zip(slots["cpu"],
                                                       slots["cuda"]))
        assert (factor < 1) == bool((slots["cpu"][1] == E * cap).any())
        want = res["cpu", torch.float64]
        for i, name in enumerate(("y", "aux", "dx", "dgate", "dw1", "db1",
                                  "dw2", "db2")):
            err = [((res[k][i] - want[i]).norm() / want[i].norm()).item()
                   for k in (("cuda", torch.float32),
                             ("cpu", torch.float32))]
            print("%s: relative L2 from f64, card %.3g, CPU %.3g"
                  % (name, *err))
            assert err[0] <= 2 * err[1] + 1e-6, (name, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.cuda
def test_flash_at_seq2048_training_shape():
    """K1 and K2 where bench.py's seq-2048 sub-bench runs them: GPT-3
    1.3B on 4 x 2048, 16 heads, d 128, causal, bf16, against the plain
    versions one batch row at a time."""
    _need_hopper()
    b, s, h, d = 4, 2048, 16, 128
    q, k, v, do = _flash_inputs(b, s, s, h, d, torch.bfloat16, seed=13)
    scale = d ** -0.5
    assert fa.uses_fused_bwd(s, s, d)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    got = fa.flash_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches - counts[0],
            fa.flash_bwd_fused.launches - counts[1]) == (1, 1)
    for i in range(b):
        row = slice(i, i + 1)
        want_out, want_lse = _ref_fwd(q[row], k[row], v[row], True, scale)
        _assert_close(out[row], want_out, FLASH_TOL["bfloat16"], "out")
        _assert_lse_close(lse[row], want_lse)
        want = _ref_bwd(q[row], k[row], v[row], out[row], lse[row], do[row],
                        True, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _assert_close(g[row], w, FLASH_TOL["bfloat16"], name)
        del want_out, want_lse, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, -2])
def test_dropout_replays_inside_checkpoint_on_the_card(interval):
    """A 2-layer GPT of head_dim 64 in bf16 on the card with dropout and
    attention dropout 0.1, with and without recompute, the same weights
    and seed: the masks drawn from the CUDA generator are the same (a
    recomputed block draws its forward's again), the loss is equal bit
    for bit, the grads within 1e-2 relative L2 (K2's dq atomics); K1 runs
    again in each recomputed block."""
    _need_hopper()
    import paddle_tpu_torch
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.functional import common

    L = 2
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=L, num_heads=4,
               max_position_embeddings=512, lm_ce_chunks=4, dropout=0.1,
               attention_dropout=0.1, recompute_interval=interval)
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
    labels = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
    draw = common.dropout_mask
    res = []
    for recompute in (False, True):
        m = GPTForCausalLM(GPTConfig(recompute=recompute, **cfg),
                           dtype=torch.bfloat16, seed=0)
        rc = sum(blk.recompute for blk in m.gpt.h)
        drawn = []

        def recorded(shape, p, device):
            keep = draw(shape, p, device)
            assert keep.device.type == "cuda"
            drawn.append(keep)
            return keep

        common.dropout_mask = recorded
        try:
            paddle_tpu_torch.seed(5)
            k1 = fa.flash_fwd.launches
            loss = m(ids, labels=labels)
            grads = torch.autograd.grad(loss, list(m.parameters()))
            torch.cuda.synchronize()
        finally:
            common.dropout_mask = draw
        assert fa.flash_fwd.launches - k1 == L + rc
        assert len(drawn) == 1 + 3 * L + 3 * rc
        res.append((loss, grads, drawn))
    (l_off, g_off, d_off), (l_on, g_on, d_on) = res
    assert all(torch.equal(a, b_) for a, b_ in zip(d_on, d_off))
    again = d_on[1 + 3 * L:]
    chosen = [j for j in range(L) if m.gpt.h[j].recompute][::-1]
    for n, j in enumerate(chosen):
        for a, b_ in zip(again[3 * n:3 * n + 3], d_off[1 + 3 * j:4 + 3 * j]):
            assert torch.equal(a, b_), j
    assert torch.equal(l_on, l_off)
    for i, (a, w_) in enumerate(zip(g_on, g_off)):
        assert bool(torch.isfinite(a).all()), i
        assert _rel_l2(a, w_) <= 1e-2, (i, _rel_l2(a, w_))


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False], ids=["m", "v"])
def test_q8_quantize_on_the_card_matches_the_cpu(signed):
    """The 8-bit moments' encoding and decoding on the card equal the
    CPU's, bit for bit, given the same input and the same noise (and
    without noise), a ragged last block included."""
    _need_hopper()
    from paddle_tpu_torch.optimizer.optimizers import (_q8_dequantize,
                                                       _q8_quantize)

    rng = np.random.RandomState(2)
    n = 3 * 256 + 77
    x = (rng.randn(n) * 10.0 ** rng.uniform(-8, 1, n)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    noise = torch.from_numpy(rng.rand(4, 256).astype(np.float32))
    for u in (None, noise):
        cpu = _q8_quantize(torch.from_numpy(x), signed, u)
        card = _q8_quantize(torch.from_numpy(x).cuda(), signed,
                            None if u is None else u.cuda())
        for a, b_ in zip(cpu, card):
            assert torch.equal(a, b_.cpu())
        back = _q8_dequantize(*card, (n,), signed)
        assert torch.equal(back.cpu(), _q8_dequantize(*cpu, (n,), signed))


# name -> (sq, sk, heads, causal, dtype)
DECODE_FLASH_SHAPES = {
    "sq1": (1, 132, 4, False, torch.bfloat16),
    "sq4_sk132": (4, 132, 4, True, torch.bfloat16),
    "sq1_f32_sk157_h16": (1, 157, 16, False, torch.float32),
    "sq1_f32_sk129_h32": (1, 129, 32, False, torch.float32),
    "sq1_f32_sk160_h32": (1, 160, 32, False, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(DECODE_FLASH_SHAPES))
def test_flash_fwd_at_the_decode_shapes(shape):
    """K1 where decoding calls it, at d 128: one query a row over a
    cache of 132 keys (``forward(caches=...)``'s token: full attention),
    and 4 queries over 132 keys causal (a chunk after a cache of 128:
    the bottom-right mask is the JAX ``_offset_causal_mask``), in bf16;
    one query a row in f32 over 129-160 keys (the cached forward loop of
    a 2-layer f32 model, 16 or 32 heads, ragged against the key tiles).
    Against the plain version row by row."""
    _need_hopper()
    sq, sk, h, causal, dtype = DECODE_FLASH_SHAPES[shape]
    q, k, v, _ = _flash_inputs(3, sq, sk, h, 128, dtype, seed=5)
    scale = 128 ** -0.5
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_out, want_lse = _ref_fwd(q, k, v, causal, scale)
    _assert_close(out, want_out, FLASH_TOL[str(dtype).split(".")[1]],
                  "out " + shape)
    _assert_lse_close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4", "int4_ragged", "kv"])
def test_decode_quantizers_on_the_card_match_the_cpu(kind):
    """The decode path's weight and KV quantizers on the card equal the
    CPU's (which equal the JAX package's, tests/test_torch_generation.py)
    bit for bit: the divisions by 127 and 7 are true divisions there too."""
    _need_hopper()
    from paddle_tpu_torch.models import generation as gen

    rng = np.random.RandomState(6)
    shape = {"int8": (512, 96), "int4": (512, 96), "int4_ragged": (200, 256),
             "kv": (8, 4, 40, 128)}[kind]
    x = (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 0, shape)) \
        .astype(np.float32)
    fn = {"int8": gen._quantize_w, "int4": gen._quantize_w4,
          "int4_ragged": gen._quantize_w4, "kv": gen._quantize_kv}[kind]
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(x).to(dtype)
        cpu, card = fn(t), fn(t.cuda())
        assert set(cpu) == set(card)
        for key in cpu:
            assert card[key].dtype == cpu[key].dtype
            assert torch.equal(card[key].cpu(), cpu[key]), (dtype, key)
