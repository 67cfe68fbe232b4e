"""The measuring tools of the fp32 tensor-core cores, on the CPU.

`tools/fp32_variants.py` writes copies of `csrc/` with one design choice of
`csrc/attention_fp32.cuh` or `csrc/gemm_fp32.cuh` changed, for A/B rounds on
the card (`tools/time_fwd_trees.py --fp32 --tree NAME=DIR`): each variant's
edits must find their text exactly once in the current sources, so a change
to a core that a variant no longer matches fails here rather than on the
card.  `tools/mma_tf32_peak.py` and the timing tool refuse to run without a
CUDA device.
"""

import filecmp

import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.tools import fp32_variants, mma_tf32_peak


@pytest.mark.parametrize("name", sorted(fp32_variants.VARIANTS))
def test_every_variant_applies_to_the_current_sources(tmp_path, name):
    dst = fp32_variants.write_variant(name, tmp_path)
    changed = {f for f in fp32_variants.VARIANTS[name]}
    cmp = filecmp.dircmp(fp32_variants.CSRC, dst)
    assert not cmp.left_only and not cmp.right_only
    assert set(cmp.diff_files) == changed


def test_variants_main_writes_the_named_ones_and_refuses_others(tmp_path, capsys):
    assert fp32_variants.main([str(tmp_path), "warp_split"]) == [str(tmp_path / "warp_split")]
    with pytest.raises(SystemExit):
        fp32_variants.main([str(tmp_path), "no_such_variant"])


def test_mma_peak_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        mma_tf32_peak.main([])
