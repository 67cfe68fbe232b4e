"""The ADE20K presets' entry points in the port on the CPU, on a written
ADE20K tree (Pillow JPEGs of mixed sampling, 8-bit label PNGs): `tools/train.py`
on the ViT preset narrowed (from a stub CLIP archive, with validation on the
`validation` split), `tools/test.py` (slide; whole mode refused on the
683-wide canvas as the JAX ViT refuses it), `tools/import_checkpoint.py`
against the JAX package's CLI, and `build_service` answering a JPEG body.
"""

import io
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu_torch.core.config import load_config as t_load
from denseclip_vit_multimodal_tpu_torch.data.ade20k import ADE20K_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build

# the references: Pillow and the JAX package (absent on the card: the file skips)
Image = pytest.importorskip("PIL.Image")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
j_load = pytest.importorskip("denseclip_vit_multimodal_tpu.core.config").load_config
j_build = pytest.importorskip("denseclip_vit_multimodal_tpu.models.denseclip").build_denseclip
from test_torch_ade20k_presets import SETS, VIT  # noqa: E402  (skips without JAX as well)


def _write_tree(root, rs):
    for split, n in (("training", 4), ("validation", 2)):
        img_dir = osp.join(root, "ADEChallengeData2016", "images", split)
        ann_dir = osp.join(root, "ADEChallengeData2016", "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(n):
            h, w = (96, 128) if i % 2 else (120, 90)
            name = f"ADE_{split[:5]}_{i:08d}"
            Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                osp.join(img_dir, name + ".jpg"), quality=90, subsampling=i % 3)
            Image.fromarray(rs.randint(0, 151, (h, w)).astype(np.uint8), mode="L").save(
                osp.join(ann_dir, name + ".png"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny ViT ADE20K run through `tools/train.py` from a stub CLIP
    archive: 2 steps, then validation on the `validation` split."""
    from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
    from torch_clip_files import write_stub_clip

    tmp = tmp_path_factory.mktemp("ade_run")
    tree, archive, wd = tmp / "tree", tmp / "ViT-B-16.pt", tmp / "wd"
    _write_tree(str(tree), np.random.RandomState(23))
    write_stub_clip(str(archive), (64, 2, 16, 197, 32), (64, 1, 49408, 77, 32))
    sets = SETS[VIT] + [f"data.path={tree}", "data.crop_size=[64,64]", "training.batch_size=2",
                        "training.workers=2"]
    summary = train_tool.main([VIT, "--device", "cpu", "--max-steps", "2", "--work-dir", str(wd),
                               "--set", *sets, f"model.clip_pretrained={archive}"])
    return summary, wd, sets


def test_train_tool_runs_with_validation(trained):
    summary, wd, _ = trained
    assert summary["step"] == 2.0 and np.isfinite(summary["loss_total"])
    assert np.isfinite(summary["miou"]) and 0.0 <= summary["pixel_acc"] <= 1.0
    log = (wd / "train.log").read_text()
    assert "loaded CLIP weights" in log and "no validation data" not in log
    steps = [json.loads(line) for line in (wd / "train_log.jsonl").read_text().splitlines()]
    assert [s["step"] for s in steps] == [1, 2]


def test_test_tool_slide_and_whole(trained):
    """Slide at a narrowed protocol on the 512x683 canvas (150 per-class IoUs);
    whole mode of the ViT refuses the 683-wide canvas, as the JAX ViT does
    (683 is not a multiple of the patch)."""
    from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool

    _, wd, sets = trained
    results = test_tool.main([VIT, str(wd), "--device", "cpu", "--mode", "slide", "--crop",
                              "128", "128", "--stride", "96", "96", "--single-protocol",
                              "--set", *sets])
    assert np.isfinite(results["mIoU"]) and 0.0 <= results["pixel_acc"] <= 1.0
    assert sum(k.startswith("iou/") for k in results) == 150 and "iou/wall" in results
    with pytest.raises(ValueError, match="not divisible by patch 16"):
        test_tool.main([VIT, str(wd), "--device", "cpu", "--mode", "whole", "--set", *sets])


def test_import_checkpoint_matches_jax(trained, tmp_path):
    """`tools/import_checkpoint.py` on one reference trainer file (towers,
    contexts, the context decoder, the fusion neck; the FPN head has no
    reference mapping in either package), in both packages: the same tensors."""
    from denseclip_vit_multimodal_tpu.train.checkpoint import restore_checkpoint
    from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_state
    from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict
    from denseclip_vit_multimodal_tpu_torch.tools import import_checkpoint as t_cli
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from torch_clip_files import (reference_context_decoder_state, reference_state,
                                  stub_clip_state)
    from tools import import_checkpoint as j_cli

    _, _, sets = trained
    model, _ = t_build(t_load(VIT, overrides=sets).model, ADE20K_CLASSES, device="cpu", seed=3)
    own = {k: v for k, v in model.state_dict().items()
           if not k.startswith(("decode_head.", "context_decoder."))}
    # 17 positions, the model's own 4 x 4 grid, and its proj [64, 512]: every tower
    # tensor imports, with no resize between the two importers
    clip = {k: v.float() for k, v in stub_clip_state((64, 2, 16, 17, 512),
                                                     (64, 1, 49408, 77, 32), seed=4).items()}
    ref = {k: torch.as_tensor(v) for k, v in reference_state(clip, own).items()}
    ref.update({k: torch.from_numpy(v) for k, v in
                reference_context_decoder_state(32, 32, 1, seed=5).items()})
    pth = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in ref.items()}}, str(pth))
    cfg_args = [VIT, str(pth), "--set", *sets]
    j_cli.main(cfg_args[:2] + ["--out", str(tmp_path / "jax")] + cfg_args[2:])
    path = t_cli.main(cfg_args[:2] + ["--out", str(tmp_path / "port"), "--device", "cpu"]
                      + cfg_args[2:])
    assert path.endswith("epoch_3.pt")
    jcfg = j_load(VIT, overrides=sets)
    jm, texts = j_build(jcfg.model, ADE20K_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray(texts))
    state, epoch, _ = restore_checkpoint(str(tmp_path / "jax"), j_state(jm, variables, {}, 1))
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, state.params),
                               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    restored, _ = t_build(t_load(VIT, overrides=sets).model, ADE20K_CLASSES, device="cpu",
                          seed=11)
    assert load_model_weights(str(tmp_path / "port"), restored) == epoch == 3
    got = restored.state_dict()
    for prefix in ("backbone.", "text_encoder.", "contexts", "context_decoder.", "neck.fuse."):
        assert any(k.startswith(prefix) for k in want), prefix
    for key, value in want.items():
        if key.startswith("decode_head."):
            continue  # neither package imports an FPN head: both keep their own init
        assert torch.equal(got[key], value), key


def _jpeg(array, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def test_service_answers_a_jpeg_body(trained, monkeypatch):
    """`build_service` on the ADE20K preset; a JPEG body answers what
    `predict_array` answers on the decoded pixels; a progressive body goes to
    Pillow, and without Pillow answers 400 naming the mode."""
    from denseclip_vit_multimodal_tpu_torch.tools import serve
    from denseclip_vit_multimodal_tpu_torch.utils import imageio

    _, wd, sets = trained
    args = serve.parse_args([VIT, str(wd), "--device", "cpu", "--mode", "slide", "--crop", "64",
                             "64", "--stride", "48", "48", "--set", *sets])
    service, epoch = serve.build_service(args)
    try:
        assert service.inferencer.num_classes == 150
        frame = np.random.RandomState(24).randint(0, 256, (96, 128, 3), dtype=np.uint8)
        body = _jpeg(frame, quality=90)
        status, ctype, payload = service.handle_predict(body, {})
        assert status == 200, payload
        got = np.load(io.BytesIO(payload))
        want = service.predict_array(imageio.decode_jpeg(body))
        np.testing.assert_array_equal(got["seg"], want["seg"])
        assert got["seg"].shape == (96, 128) and int(got["seg"].max()) < 150
        progressive = _jpeg(frame, progressive=True)
        assert service.handle_predict(progressive, {"format": ["json"]})[0] == 200
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)  # Pillow not installed
        status, _, payload = service.handle_predict(progressive, {})
        assert status == 400 and b"progressive" in payload
        assert service.handle_predict(body, {})[0] == 200  # a baseline body needs no Pillow
    finally:
        service.close()
