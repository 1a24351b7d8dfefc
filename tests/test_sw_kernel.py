"""One case table for Smith-Waterman scoring, run two ways.

CPU half: every case checks the scan (ops.sw.sw_score) against the
triple-loop oracle (tests/oracles.py), or against a known answer where
the oracle would be too slow. GPU half (marker ``gpu``, skipped without
a card; chip_smoke.py runs it): the same case checks the CUDA kernel
(ops.sw_cuda) against the scan on the card, exactly — the DP is int32,
so there is no tolerance.

The remaining tests cover what surrounds the kernel and runs anywhere:
the dispatcher's choice per platform and parameters, the lowering of
one jitted function to the kernel on CUDA and to the scan on the CPU,
the folding of vmap axes into the kernel's batch, the query-tiling
scratch shape, and a failed build raising instead of falling back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import pytest

from breakmer_tpu.encode import ReadBatch, decode_seq
from breakmer_tpu.ops.sw import SWParams, sw_impl, sw_score, sw_score_auto
from tests.oracles import oracle_sw
from tests.test_sw import CASES, _random_cases

CUSTOM = SWParams(match=3, mismatch=2, gap_open=4, gap_extend=2)
CHEAP_GAPS = SWParams(match=1, mismatch=1, gap_open=0, gap_extend=1)


def _batch(qs, ts, pad_q, pad_t):
    return (ReadBatch.from_seqs(qs, pad_to=pad_q).codes,
            ReadBatch.from_seqs(ts, pad_to=pad_t).codes)


def _acgt(rng, n):
    return "".join(rng.choice(list("ACGT"), int(n)))


@dataclasses.dataclass
class Case:
    name: str
    build: Callable[[], Tuple[np.ndarray, np.ndarray]]
    params: SWParams = SWParams()
    # (score, q_end, t_end) per pair where the oracle would be too slow
    expect: Optional[List[Tuple[int, int, int]]] = None


def _cases_small():
    return _batch([a for a, _ in CASES + _random_cases(8)],
                  [b for _, b in CASES + _random_cases(8)], 128, 128)


def _unaligned_batch():
    # B=3: no batch padding anywhere, one warp per pair on the card
    return _batch([a for a, _ in CASES[:3]], [b for _, b in CASES[:3]], 128, 256)


def _tiny_lengths():
    # lengths far below one lane's rows: most kernel rows are masked
    pairs = CASES + [("NNNN", "ACGT"), ("A", "A")]
    return _batch([a for a, _ in pairs], [b for _, b in pairs], 16, 16)


def _rect_planted():
    rng = np.random.default_rng(3)
    qs = [_acgt(rng, 100) for _ in range(8)]
    ts = [_acgt(rng, 300) for _ in range(8)]
    for i in range(0, 8, 4):
        ts[i] = ts[i][:50] + qs[i] + ts[i][150:]
    return _batch(qs, ts, 128, 384)


def _ragged_n_free():
    rng = np.random.default_rng(7)
    qs = [_acgt(rng, n) for n in rng.integers(40, 120, 8)]
    ts = [_acgt(rng, n) for n in rng.integers(150, 300, 8)]
    for i in range(0, 8, 3):
        ts[i] = ts[i][:30] + qs[i] + ts[i][30:]
    return _batch(qs, ts, 128, 512)


def _zero_mismatch():
    pairs = CASES + _random_cases(4)
    return _batch([a for a, _ in pairs], [b for _, b in pairs], 128, 128)


def _planted(pad_q, pad_t, seed):
    def build():
        rng = np.random.default_rng(seed)
        qs = [_acgt(rng, 90) for _ in range(2)]
        ts = [_acgt(rng, pad_t - 10) for _ in range(2)]
        ts[1] = ts[1][:40] + qs[1] + ts[1][130:]
        return _batch(qs, ts, pad_q, pad_t)
    return build


def _hits_across_columns():
    # planted hits spread along the target, across 128-column boundaries
    rng = np.random.default_rng(21)
    qs = [_acgt(rng, 100) for _ in range(4)]
    ts = [_acgt(rng, 500) for _ in range(4)]
    for i, j0 in enumerate((80, 200, 340, 460)):
        ts[i] = (ts[i][:j0] + qs[i] + ts[i][j0 + 100:])[:500]
    return _batch(qs, ts, 128, 512)


def _tie_heavy():
    # 2-letter alphabet: many equal-score cells, so the (diagonal, row)
    # tie-break decides q_end/t_end
    rng = np.random.default_rng(22)
    return (rng.integers(0, 2, (6, 128), dtype=np.int8),
            rng.integers(0, 2, (6, 256), dtype=np.int8))


def _n_run_in_target():
    rng = np.random.default_rng(23)
    qs = [_acgt(rng, n) for n in rng.integers(60, 120, 4)]
    ts = [_acgt(rng, n) for n in rng.integers(300, 380, 4)]
    for i in range(0, 4, 2):
        ts[i] = ts[i][:120] + qs[i] + ts[i][120:]
    q, t = _batch(qs, ts, 128, 384)
    t[:, 124:132] = 4
    return q, t


def _n_run_in_query():
    rng = np.random.default_rng(25)
    qs = [_acgt(rng, 110) for _ in range(4)]
    ts = [_acgt(rng, 40) + q + _acgt(rng, 40) for q in qs]
    q, t = _batch(qs, ts, 128, 256)
    q[:, 50:56] = 4
    return q, t


def _uneven_tail():
    rng = np.random.default_rng(24)
    qs = [_acgt(rng, 90) for _ in range(4)]
    ts = [_acgt(rng, 320) for _ in range(4)]
    ts[1] = (ts[1][:230] + qs[1] + ts[1][230:])[:320]
    return _batch(qs, ts, 128, 320)


def _beyond_tier():
    # a contig past the largest tier: 4 query tiles on the card
    rng = np.random.default_rng(5)
    qs = _acgt(rng, 3000)
    return _batch([qs], [qs[500:2500]], 4096, 4096)


def _hit_across_query_tiles():
    # the only positive-scoring path crosses query row 1024, where the
    # kernel hands the last row of one tile to the next
    rng = np.random.default_rng(26)
    qs = _acgt(rng, 1500)
    return _batch([qs, qs], [qs[1000:1200], qs[900:1100]], 2048, 256)


SW_CASES = [
    Case("cases", _cases_small),
    Case("unaligned_batch", _unaligned_batch),
    Case("tiny_lengths", _tiny_lengths),
    Case("tiny_lengths_custom", _tiny_lengths, CUSTOM),
    Case("rect_planted", _rect_planted),
    Case("custom_params", _cases_small, CUSTOM),
    Case("ragged_n_free", _ragged_n_free),
    Case("ragged_n_free_custom", _ragged_n_free, CUSTOM),
    Case("zero_mismatch", _zero_mismatch, SWParams(2, 0, 5, 1)),
    Case("square_128x128", _planted(128, 128, 11)),
    Case("long_target_128x1024", _planted(128, 1024, 12)),
    Case("q256_t384", _planted(256, 384, 13)),
    Case("hits_across_columns", _hits_across_columns),
    Case("tie_heavy", _tie_heavy),
    Case("tie_heavy_cheap_gaps", _tie_heavy, CHEAP_GAPS),
    Case("n_run_in_target", _n_run_in_target),
    Case("n_run_in_query", _n_run_in_query),
    Case("uneven_tail_320", _uneven_tail),
    Case("beyond_tier_4096", _beyond_tier, expect=[(4000, 2499, 1999)]),
    Case("hit_across_query_tiles", _hit_across_query_tiles,
         expect=[(400, 1199, 199), (400, 1099, 199)]),
]


def _rows(out):
    return [tuple(int(np.asarray(x)[b]) for x in out)
            for b in range(len(np.asarray(out[0])))]


@pytest.mark.parametrize("case", SW_CASES, ids=lambda c: c.name)
def test_scan_matches_oracle(case):
    q, t = case.build()
    got = _rows(sw_score(q, t, case.params))
    if case.expect is not None:
        assert got == case.expect
        return
    p = case.params
    for b, row in enumerate(got):
        # trailing pad never beats or ties its in-bounds ancestor, so the
        # oracle may run on the unpadded sequences
        want = oracle_sw(decode_seq(q[b]).rstrip("N"), decode_seq(t[b]).rstrip("N"),
                         p.match, p.mismatch, p.gap_open, p.gap_extend)
        assert row == want, f"pair {b}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", SW_CASES, ids=lambda c: c.name)
def test_kernel_matches_scan(case, gpu):
    from breakmer_tpu.ops.sw_cuda import sw_score_cuda

    q, t = case.build()
    want = _rows(sw_score(q, t, case.params))
    assert _rows(sw_score_cuda(q, t, case.params)) == want
    if case.expect is not None:
        assert want == case.expect


@pytest.mark.gpu
def test_kernel_under_vmap_matches_scan(gpu):
    import jax

    from breakmer_tpu.ops.sw_cuda import sw_score_cuda

    rng = np.random.default_rng(31)
    q = rng.integers(0, 5, (3, 7, 128), dtype=np.int8)
    t = rng.integers(0, 5, (3, 7, 256), dtype=np.int8)
    got = jax.jit(jax.vmap(sw_score_cuda))(q, t)
    want = jax.vmap(sw_score)(q, t)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dispatch_by_platform_and_params():
    assert sw_impl("cpu") == "scan"
    assert sw_impl("gpu") == "cuda"
    assert sw_impl("cuda", CHEAP_GAPS) == "cuda"
    # the kernel's boundary values assume non-negative gap penalties
    assert sw_impl("gpu", SWParams(gap_open=-1)) == "scan"
    assert sw_impl("gpu", SWParams(gap_extend=-1)) == "scan"


def _lowered(platform, fn, *args):
    import jax

    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


def test_one_function_lowers_to_kernel_on_cuda_and_scan_on_cpu():
    q = np.zeros((5, 128), np.int8)
    t = np.zeros((5, 256), np.int8)
    cuda = _lowered("cuda", sw_score_auto, q, t)
    assert "custom_call @breakmer_sw_score" in cuda
    assert "stablehlo.while" not in cuda
    cpu = _lowered("cpu", sw_score_auto, q, t)
    assert "custom_call" not in cpu and "stablehlo.while" in cpu
    # parameters outside the kernel's envelope take the scan on CUDA too
    neg = _lowered("cuda", lambda a, b: sw_score_auto(a, b, SWParams(gap_open=-1)), q, t)
    assert "custom_call" not in neg


@pytest.mark.parametrize("lq,carry", [(128, (3, 4, 1)), (1024, (3, 4, 1)),
                                      (1025, (3, 4, 512)), (4096, (3, 4, 512))])
def test_vmap_folds_into_kernel_batch(lq, carry):
    """vmap adds leading axes to the one custom call (the handler folds
    them into its batch); the scratch for query tiling appears only past
    one tile of rows."""
    import jax

    q = np.zeros((3, 4, lq), np.int8)
    t = np.zeros((3, 4, 256), np.int8)
    text = _lowered("cuda", jax.vmap(sw_score_auto), q, t)
    calls = [ln for ln in text.splitlines() if "custom_call @breakmer_sw_score" in ln]
    assert len(calls) == 1
    assert f"(tensor<3x4x{lq}xi8>, tensor<3x4x256xi8>)" in calls[0]
    outs = "x".join(map(str, carry))
    assert (f"-> (tensor<3x4xi32>, tensor<3x4xi32>, tensor<3x4xi32>, "
            f"tensor<{outs}xi32>)") in calls[0]


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: when the kernel cannot be built the call fails."""
    from breakmer_tpu.ops import sw_cuda

    monkeypatch.setattr(sw_cuda, "_LIB", tmp_path / "libsw.so")
    monkeypatch.setattr(sw_cuda, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="building sw_cuda.cu failed"):
        sw_cuda.build()
    assert not list(tmp_path.glob("libsw*"))
