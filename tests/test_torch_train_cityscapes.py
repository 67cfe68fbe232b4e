"""The slice end to end on the CPU: a tiny flagship fine-tuned from a stub
OpenAI CLIP archive on an on-disk Cityscapes tree through the port's entry
points (`tools/train.py`, `--load`, `tools/test.py`,
`tools/import_checkpoint.py`), and the first step's loss against the JAX
package's on the same decoded batch and imported weights."""

import io
import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import clip_import as j_ci
from denseclip_vit_multimodal_tpu.train import losses as j_losses
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.core.config import load_config
from denseclip_vit_multimodal_tpu_torch.data.augment import normalize_image
from denseclip_vit_multimodal_tpu_torch.data.cityscapes import CityscapesDepthSegDataset
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.tools import import_checkpoint
from denseclip_vit_multimodal_tpu_torch.tools import test as test_tool
from denseclip_vit_multimodal_tpu_torch.tools import train as train_tool
from denseclip_vit_multimodal_tpu_torch.train import checkpoint as ckpt_lib
from denseclip_vit_multimodal_tpu_torch.train import losses as t_losses
from denseclip_vit_multimodal_tpu_torch.train.clip_import import load_clip_into_model
from torch_clip_files import reference_state, write_stub_clip

CONFIG = osp.join(osp.dirname(__file__), "..", "configs", "denseclip_vitb16_cityscapes_multitask.yaml")
H, W = 64, 128
VW, VL, TW, TL = 64, 2, 64, 1  # the tiny towers
TINY = [f"model.backbone.width={VW}", f"model.backbone.layers={VL}", "model.backbone.heads=2",
        "model.backbone.out_indices=[0,1]", f"model.text_encoder.transformer_layers={TL}",
        f"model.text_encoder.transformer_width={TW}", "model.text_encoder.transformer_heads=2",
        f"model.token_embed_dim={TW}", "model.neck.inter_channels=16",
        "model.neck.out_channels=32", "model.decode_head.in_channels=32",
        "model.decode_head.channels=32", "model.depth_head.in_channels=32",
        "model.depth_head.channels=16", "tpu.compute_dtype=float32",
        f"data.crop_size=[{H},{W}]", "training.batch_size=2"]
# fp32: the loss is the same arithmetic in another order (tests/test_torch_train_model.py)
TOL_LOSS = 1e-5


def _write_tree(root, rs):
    for split, n in (("train", 4), ("val", 2)):
        for i in range(n):
            city = ("aachen", "bochum")[i % 2]
            disparity = rs.randint(0, 30000, (H, W)).astype(np.uint16)
            disparity[::5] = 0
            for top, suffix, arr in (
                    ("leftImg8bit", "leftImg8bit", rs.randint(0, 256, (H, W, 3), dtype=np.uint8)),
                    ("gtFine", "gtFine_labelIds", rs.randint(0, 34, (H, W)).astype(np.uint8)),
                    ("disparity", "disparity", disparity)):
                folder = osp.join(root, top, split, city)
                os.makedirs(folder, exist_ok=True)
                Image.fromarray(arr).save(osp.join(folder, f"{city}_{i:06d}_000019_{suffix}.png"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tree, the archive, and `tools/train.py` for 2 steps on them."""
    tmp = tmp_path_factory.mktemp("cityscapes_run")
    tree, archive = str(tmp / "cityscapes"), str(tmp / "ViT-B-16.pt")
    _write_tree(tree, np.random.RandomState(0))
    clip = write_stub_clip(archive, (VW, VL, 16, 197, 512), (TW, TL, 49408, 77, 512))
    sets = ["--set", *TINY, f"data.path={tree}", f"model.clip_pretrained={archive}"]
    work_dir = str(tmp / "wd")
    summary = train_tool.main([CONFIG, "--device", "cpu", "--no-validate", "--max-steps", "2",
                               "--work-dir", work_dir, *sets])
    return {"tmp": tmp, "tree": tree, "archive": archive, "clip": clip, "sets": sets,
            "work_dir": work_dir, "summary": summary}


def test_train_imports_clip_and_takes_steps(run):
    assert run["summary"]["step"] == 2.0 and np.isfinite(run["summary"]["loss_total"])
    with open(osp.join(run["work_dir"], "train.log")) as f:
        log = f.read()
    assert f"{12 * VL + 8} visual / {12 * TL + 5} text tensors" in log
    with open(osp.join(run["work_dir"], "train_log.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(s["data_s"] >= 0.0 and s["step_s"] > 0.0 for s in steps)
    # the preset freezes both towers: the checkpoint holds the archive's weights
    model = torch.load(osp.join(run["work_dir"], "checkpoints", "latest"),
                       weights_only=True)["model"]
    clip = run["clip"]
    assert torch.equal(model["backbone.patch_embed.weight"],
                       clip["visual.conv1.weight"].float().permute(0, 2, 3, 1).reshape(VW, -1))
    assert torch.equal(model["text_encoder.positional_embedding"],
                       clip["positional_embedding"][:22].float())
    assert torch.equal(model["backbone.proj"], clip["visual.proj"].float())


def test_load_warm_starts_at_step_0_from_the_checkpoint(run, monkeypatch):
    source = torch.load(osp.join(run["work_dir"], "checkpoints", "latest"), weights_only=True)
    loaded = {}
    original = ckpt_lib.load_model_weights

    def capture(path, model, which="latest"):
        epoch = original(path, model, which)
        loaded.update({k: v.clone() for k, v in model.state_dict().items()})
        return epoch

    monkeypatch.setattr(ckpt_lib, "load_model_weights", capture)
    load_dir = str(run["tmp"] / "wd_load")
    summary = train_tool.main([CONFIG, "--device", "cpu", "--no-validate", "--max-steps", "1",
                               "--load", run["work_dir"], "--work-dir", load_dir, *run["sets"]])
    assert summary["step"] == 1.0 and source["step"] == 2
    with open(osp.join(load_dir, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1]
    assert sorted(loaded) == sorted(source["model"])
    for key, value in source["model"].items():
        assert torch.equal(loaded[key], value), key
    with pytest.raises(RuntimeError, match="size mismatch"):  # another model fails loudly
        train_tool.main([CONFIG, "--device", "cpu", "--no-validate", "--max-steps", "1",
                         "--load", run["work_dir"], "--work-dir", str(run["tmp"] / "wd_bad"),
                         *run["sets"], "model.neck.out_channels=48",
                         "model.decode_head.in_channels=48", "model.depth_head.in_channels=48"])


EVAL_KEYS = ["mIoU", "pixel_acc"] + [f"depth/{k}" for k in
                                     ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")]


def test_evaluate_on_val_with_the_slide_protocol(run):
    results = test_tool.main([CONFIG, run["work_dir"], "--device", "cpu", "--mode", "slide",
                              "--crop", "64", "64", "--stride", "48", "48", "--single-protocol",
                              "--eval", "mIoU", "depth", *run["sets"]])
    assert all(np.isfinite(results[k]) for k in EVAL_KEYS), results
    assert results["images_per_sec"] > 0


def test_import_checkpoint_then_evaluate(run):
    """A reference trainer file built from the run's checkpoint (the
    reference's names, `module.` prefixes) through the import CLI back to
    the same weights, which `tools/test.py` restores."""
    source = torch.load(osp.join(run["work_dir"], "checkpoints", "latest"),
                        weights_only=True)["model"]
    ref = reference_state(run["clip"], source)
    pth = str(run["tmp"] / "reference.pth")
    torch.save({"epoch": 4, "best_metric": None,
                "state_dict": {f"module.{k}": v for k, v in ref.items()}}, pth)
    out = str(run["tmp"] / "wd_import")
    import_checkpoint.main([CONFIG, pth, "--out", out, "--device", "cpu", *run["sets"]])
    imported = torch.load(osp.join(out, "checkpoints", "latest"), weights_only=True)["model"]
    for key, value in source.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(imported[key], value), key
    results = test_tool.main([CONFIG, out, "--device", "cpu", "--max-samples", "1",
                              "--eval", "mIoU", "depth", *run["sets"]])
    assert all(np.isfinite(results[k]) for k in EVAL_KEYS), results


def test_first_step_loss_matches_jax(run):
    """The training forward and loss of one step (dropout 0, drop path 0) on
    the same decoded batch with the same imported weights."""
    cfg = load_config(CONFIG, overrides=run["sets"][1:] + ["model.decode_head.dropout_ratio=0",
                                                           "model.depth_head.dropout_ratio=0"])
    model_cfg = cfg.model.to_dict()
    ds = CityscapesDepthSegDataset(run["tree"], "train")
    samples = [ds[0], ds[1]]
    image = normalize_image(torch.from_numpy(np.stack([s["image"] for s in samples])),
                            cfg.data.norm_mean, cfg.data.norm_std).numpy()
    seg = np.stack([s["seg"] for s in samples]).astype(np.int32)
    depth = np.stack([s["depth"] for s in samples])
    mask = depth > 0

    jm, texts = j_build(model_cfg, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(texts))
    variables, _, _ = j_ci.load_clip_into_variables(jax.tree.map(np.asarray, variables),
                                                    run["archive"], model_cfg)
    out, _ = jm.apply(variables, jnp.asarray(image), jnp.asarray(texts), train=True,
                      gt_hw=(H, W), mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
    want = float(j_losses.cross_entropy_loss(out["seg"], jnp.asarray(seg))
                 + 0.1 * j_losses.silog_loss(out["depth"], jnp.asarray(depth), jnp.asarray(mask)))

    model, t_texts = t_build(model_cfg, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(model, {"params": variables["params"],
                                "batch_stats": variables["batch_stats"]})
    load_clip_into_model(model, run["archive"], model_cfg)
    with torch.no_grad():
        got_out = model(torch.from_numpy(image), t_texts, train=True, gt_hw=(H, W),
                        gen=torch.Generator().manual_seed(0))
        got = float(t_losses.cross_entropy_loss(got_out["seg"], torch.from_numpy(seg))
                    + 0.1 * t_losses.silog_loss(got_out["depth"], torch.from_numpy(depth),
                                                torch.from_numpy(mask)))
    assert np.isfinite(want) and got == pytest.approx(want, rel=TOL_LOSS)
