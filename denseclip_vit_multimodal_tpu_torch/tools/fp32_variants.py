"""Write variant copies of the port's CUDA sources for A/B rounds of the fp32
tensor-core cores on the card.

    python -m denseclip_vit_multimodal_tpu_torch.tools.fp32_variants OUT_DIR [NAME ...]

Each variant is this checkout's `csrc/` with one design choice of the fp32
forward core (`csrc/attention_fp32.cuh`) or the fp32 product
(`csrc/gemm_fp32.cuh`) changed; `tools/time_fwd_trees.py --fp32 --tree
NAME=OUT_DIR/NAME` times it in turns beside the others.  With no NAME every
variant is written.  The variants:

  warp_split     K and V land as plain fp32 (no split pass) and every warp
                 splits each K / V fragment it loads, in registers: the
                 choice the block's split pass replaces;
  pv_chain       P V output n-tile by output n-tile, each summing the tile's
                 keys in one dependent chain of HMMAs (the first design);
  split_before   tile t + 1 split before tile t's work, not after it (the
                 compiler interleaves the two and runs out of registers);
  s_one_set      S's k-steps into one accumulator set (fewer HMMA chains at
                 D 128);
  d128_w4_s16_4  head dim 128 with a four-stage ring;
  gemm_split_before  the product's k-tile t + 1 split before k-tile t's HMMAs;
  gemm_s3        the product's ring of three stages;
  gemm_round16   the product's sums rounded every 16 of K (each k-tile);
and two that compute a wrong result on purpose, to split the product's time:
  gemm_no_ln     the LayerNorm prologue left out (the split stays);
  gemm_no_mma    the HMMAs left out (loads, split, rounding and stores stay).
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# The split pass and the fragment loads of attention_fp32.cuh, and what
# `warp_split` puts in their place: plain fp32 in the landing slots (chunk
# (r, c..c + 3) at r * ld + 2c in the K plane; (2p, c..) and (2p + 1, c..) at
# p * ld + 4c and + 4c + 4 in the V plane), split at each load.
_SPLIT_STAGE = """  tf32::split_nk<C::kStep, C::D, C::kThreads>(st, C::kLdNk, tid);
  if (with_v) tf32::split_kn<C::kStep, C::D, C::kThreads>(st + C::kStep * C::kLdNk, C::kLdKn, tid);
"""
_K_FRAG = "  return tf32::frag_b_nk_split(tK + 8 * j * C::kLdNk, C::kLdNk, kk, g, t);\n"
_V_FRAG = "  return tf32::frag_b_kn_split(tV, C::kLdKn, j, 8 * dt, g, t);\n"
_WARP_SPLIT = {
    _SPLIT_STAGE: "  (void)st, (void)with_v, (void)tid;\n",
    _K_FRAG: """  const float2 x = *reinterpret_cast<const float2*>(
      tK + (8 * j + g) * C::kLdNk + 16 * kk + 8 * (t >> 1) + 2 * (t & 1));
  return split_b(x.x, x.y);
""",
    _V_FRAG: """  const int col = 8 * dt + g;
  const float* p = tV + (4 * j + t) * C::kLdKn + 4 * (col & ~3) + (col & 3);
  return split_b(p[0], p[4]);
""",
}

_PV_TILE = """    float pv[kOut][4];
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt) pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const FragA pa = c_as_a(s[j]);
#pragma unroll
      for (int dt = 0; dt < kOut; ++dt) mma_3xtf32(pv[dt], pa, v_frag<C>(tV, j, dt, g, t));
    }
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = fmaf(o[dt][e], alpha[e >> 1], pv[dt][e]);
"""
_PV_CHAIN = """    FragA pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) pa[j] = c_as_a(s[j]);
#pragma unroll
    for (int dt = 0; dt < kOut; ++dt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_3xtf32(c, pa[j], v_frag<C>(tV, j, dt, g, t));
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = fmaf(o[dt][e], alpha[e >> 1], c[e]);
    }
"""

_LOOP_BODY = """    compute(i);
    cp_async_wait<kStages - 2>();  // load i + 1 has landed (this thread's copies)
    split_stage<C>(stage(i + 1), with_v(i + 1), tid);  // past the last load: unused
"""
_LOOP_SPLIT_BEFORE = """    cp_async_wait<kStages - 2>();
    split_stage<C>(stage(i + 1), with_v(i + 1), tid);
    compute(i);
"""
_GEMM_BODY = ("      issue(kt + kGemmStages - 1);  // into k-tile kt - 1's stage, freed by the "
              "last barrier\n      const float* sa = stage(kt);\n")
_GEMM_SPLIT_BEFORE = """      issue(kt + kGemmStages - 1);
      cp_async_wait<kGemmStages - 2>();
      split(kt + 1);
      const float* sa = stage(kt);
"""
_GEMM_TAIL = ("      cp_async_wait<kGemmStages - 2>();  // k-tile kt + 1 has landed (this thread's "
              "copies)\n      split(kt + 1);\n      __syncthreads();\n")
_GEMM_TAIL_SPLIT_BEFORE = """      __syncthreads();
"""

_CORE, _GEMM = "attention_fp32.cuh", "gemm_fp32.cuh"
VARIANTS = {  # name: {file: {text: replacement}}
    "warp_split": {_CORE: _WARP_SPLIT},
    "pv_chain": {_CORE: {_PV_TILE: _PV_CHAIN}},
    "split_before": {_CORE: {_LOOP_BODY: _LOOP_SPLIT_BEFORE}},
    "s_one_set": {_CORE: {"static constexpr int kSets = NT >= 8 ? 1 : 8 / NT;":
                          "static constexpr int kSets = 1;"}},
    "d128_w4_s16_4": {_CORE: {"Tiles<128, 4, 16, 3>": "Tiles<128, 4, 16, 4>"}},
    "gemm_split_before": {_GEMM: {_GEMM_BODY: _GEMM_SPLIT_BEFORE,
                                  _GEMM_TAIL: _GEMM_TAIL_SPLIT_BEFORE}},
    "gemm_s3": {_GEMM: {"kGemmStages = 4;": "kGemmStages = 3;"}},
    "gemm_round16": {_GEMM: {"constexpr int kRoundK = 32;": "constexpr int kRoundK = 16;"}},
    "gemm_no_ln": {_GEMM: {"    x = make_float4(ln(x.x, ga.x, be.x),":
                           "    (void)make_float4(ln(x.x, ga.x, be.x),"}},
    "gemm_no_mma": {_GEMM: {"for (int mi = 0; mi < kMT; ++mi) "
                            "mma_3xtf32(part[mi][ni], af[mi], bf);":
                            "for (int mi = 0; mi < kMT; ++mi) part[mi][ni][0] += "
                            "__uint_as_float(af[mi].hi[0] ^ bf.lo[1]);"}},
}


def write_variant(name: str, out: Path) -> Path:
    """This checkout's csrc/ copied to out/name with `name`'s changes; each
    changed text must occur exactly once."""
    dst = out / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, edits in VARIANTS[name].items():
        text = (dst / fname).read_text()
        for old, new in edits.items():
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {fname} holds {text.count(old)} copies of "
                                 f"{old!r}")
            text = text.replace(old, new)
        (dst / fname).write_text(text)
    return dst


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("out", type=Path)
    p.add_argument("names", nargs="*", help=f"of {sorted(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        p.error(f"unknown variants {sorted(unknown)}")
    return [str(write_variant(name, args.out)) for name in args.names or VARIANTS]


if __name__ == "__main__":
    print("\n".join(main()))
