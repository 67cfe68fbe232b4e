"""A 2-rank data-parallel train step of the port (two spawned Gloo processes
on the CPU) against the JAX package's train step over a `{data: 2}` mesh of
two of conftest's virtual devices (`shard_batch`, replicated state), on the
same global batch, at dropout and drop path 0: the tiny seg+depth ViT at
`grad_accum_steps` 1 and 2 (JAX's microbatches are global rows; each rank
reads its rows of each); `tests/test_torch_ddp_step_rn.py` holds a tiny
ResNet (BatchNorm in the trunk) the same way.

Both steps augment on the device with an identity geometry (scale 1, the
crop the frame's size, no flip, no jitter), so the batch each sees is the
same normalised one.  Both take one SGD step at lr 1024 with no weight
decay, so JAX's gradient is (params before - params after) / 1024; the
port's is read where its optimizer applies it, after the all-reduce.  The
limits are `tests/test_torch_train_model.py`'s.  The ranks run while the
parent compiles JAX's steps.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.data.augment import AugmentConfig as JAug
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_state
from denseclip_vit_multimodal_tpu.train.step import make_train_step as j_step
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES

import torch_ddp
from test_torch_rn_path import TINY_RN
from test_torch_train_model import TOL_GRAD_REL, TOL_LOSS

LR = 1024.0
TRAINING = {"optimizer": {"type": "SGD", "lr": LR, "weight_decay": 0.0}}
FROZEN = ("text_encoder",)


VIT = {  # the seg+depth ViT at the widths of test_torch_rn_path.py's tiny models
    "type": "DenseCLIP", "text_dim": 32, "context_length": 5, "token_embed_dim": 64,
    "context_feature": "attention", "score_concat_index": -1,
    "backbone": {"type": "CLIPVisionTransformer", "patch_size": 16, "width": 64, "layers": 2,
                 "heads": 2, "input_resolution": 64, "out_indices": [0, 1],
                 "drop_path_rate": 0.0},
    "text_encoder": dict(TINY_RN["text_encoder"], transformer_layers=1),
    "neck": {"type": "ViTFeatureFusionNeck", "inter_channels": 16, "out_channels": 32},
    "decode_head": {"type": "FPNHead", "in_channels": 32, "channels": 32, "num_classes": 19,
                    "dropout_ratio": 0.0},
    "depth_head": {"type": "FCNHeadDepth", "in_channels": 32, "channels": 16,
                   "dropout_ratio": 0.0},
}


def _rn_cfg():
    cfg = copy.deepcopy(TINY_RN)
    cfg["text_encoder"] = dict(cfg["text_encoder"], transformer_layers=1)
    cfg["context_decoder"] = dict(cfg["context_decoder"], dropout=0.0)
    cfg["decode_head"] = dict(cfg["decode_head"], dropout_ratio=0.0)
    return cfg


def _batch(n, hw, depth, seed):
    rs = np.random.RandomState(seed)
    b = {"image": rs.randint(0, 256, (n, *hw, 3)).astype(np.uint8),
         "seg": rs.randint(0, 19, (n, *hw)).astype(np.int32)}
    b["seg"][rs.rand(n, *hw) < 0.1] = 255
    if depth:
        b["depth"] = rs.uniform(1.0, 80.0, (n, *hw)).astype(np.float32)
        b["depth"][rs.rand(n, *hw) < 0.1] = 0.0
    return b


def _flax_tree(shapes, collection, state_dict):
    """The Flax tree of shapes `shapes` holding `state_dict`'s values: each
    leaf's element indices go through `convert.flax_to_state_dict`, which
    says where each element lands in the port's tensors."""
    def fill(path, leaf):
        names = tuple(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(leaf.shape)), dtype=np.float32).reshape(leaf.shape)
        nested = idx
        for name in reversed(names):
            nested = {name: nested}
        out = np.empty(leaf.shape, np.float32)
        for key, where in flax_to_state_dict({collection: nested}).items():
            out.reshape(-1)[where.numpy().astype(np.int64).ravel()] = \
                state_dict[key].numpy().ravel()
        return out

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _case(cfg, hw, depth, accum, seed):
    """The port's seeded weights, perturbed as `_perturbed` perturbs JAX's,
    in both packages' layouts, and the port's payload.  JAX's tree comes
    from `eval_shape` (no init to compile).  Each rank holds 2 rows of each
    microbatch: with one, PyTorch's CPU convolutions and linears take their
    batch-1 path, whose rounding moves the bias gradients that a BatchNorm
    downstream nearly cancels by up to 5e-4 relative (as running them per
    sample in one process does), beyond the gradient limit."""
    jm, texts = j_build(cfg, CITYSCAPES_CLASSES)
    batch = _batch(4 * accum, hw, depth, seed)
    model, _ = torch_ddp._model(cfg, seed=seed)
    rs = np.random.RandomState(seed + 1)
    state_dict = {}
    for key, value in model.state_dict().items():
        v = value.numpy()
        if key.endswith(("running_mean", "running_var")):
            v = (rs.rand(*v.shape) + 0.5).astype(np.float32)
        elif v.dtype == np.float32:
            v = v + 0.1 * rs.randn(*v.shape).astype(np.float32)
        state_dict[key] = torch.from_numpy(np.ascontiguousarray(v))
    if depth:  # depth well above SILog's eps clamp (tests/test_torch_train_model.py)
        state_dict["depth_head.classifier.bias"].fill_(10.0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            batch["image"][:1].astype(np.float32), texts)
    params = _flax_tree(shapes["params"], "params", state_dict)
    stats = _flax_tree(shapes["batch_stats"], "batch_stats", state_dict)
    aug = {"crop_size": hw, "scale_range": (1.0, 1.0), "hflip_prob": 0.0}
    payload = {"task": "step_grads", "cfg": cfg, "state_dict": state_dict, "batch": batch,
               "training": TRAINING, "frozen": FROZEN, "accum": accum, "aug": aug}
    return jm, texts, params, stats, batch, aug, accum, payload


def _jax_two_device_step(jm, texts, params, stats, batch, aug, accum):
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    state = j_state(jm, {"params": params, "batch_stats": stats}, TRAINING, 1,
                    frozen_modules=FROZEN)
    step = j_step(texts, JAug(**aug), grad_accum_steps=accum, frozen_modules=FROZEN)
    new_state, metrics = step(replicate(state, mesh), shard_batch(batch, mesh),
                              jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda old, new: (old - np.asarray(new)) / LR, params,
                         jax.tree.map(np.asarray, new_state.params))
    return (float(metrics["loss_total"]), flax_to_state_dict({"params": grads}),
            flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}))


def check_step(want, ranks):
    """Loss, every trainable gradient and the BatchNorm statistics of each
    rank against JAX's, and the same update on every rank."""
    want_loss, want_grads, want_stats = want
    for got in ranks:
        assert got["metrics"]["loss_total"] == pytest.approx(want_loss, rel=TOL_LOSS)
        assert got["metrics"]["skipped"] == 0.0
        trainable = {k for k in want_grads if not k.startswith(FROZEN)}
        assert set(got["grads"]) <= trainable
        for name in trainable:
            w = want_grads[name].numpy()
            g = got["grads"].get(name)
            if g is None:  # nothing in the training forward reads it: JAX's gradient is 0
                np.testing.assert_allclose(w, 0.0, atol=1e-9, err_msg=name)
                continue
            if name.endswith("attnpool.k_proj.bias"):
                # 0 in exact arithmetic (softmax ignores a shift every key shares):
                # both are fp32 noise, held in absolute terms
                assert np.abs(w).max() < 1e-9 and np.abs(g.numpy()).max() < 1e-9, name
                continue
            rel = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert rel < TOL_GRAD_REL, (name, rel)
        assert want_stats
        for key, value in want_stats.items():
            np.testing.assert_allclose(got["buffers"][key].numpy(), value.numpy(),
                                       rtol=TOL_LOSS, atol=TOL_LOSS, err_msg=key)
    for key, g in ranks[0]["grads"].items():
        assert g.equal(ranks[1]["grads"][key]), key


@pytest.fixture(scope="module")
def runs():
    cases = {"vit": _case(VIT, (64, 128), True, 1, seed=3),
             "vit_accum": _case(VIT, (64, 128), True, 2, seed=7)}
    ranks = torch_ddp.start({name: c[-1] for name, c in cases.items()})
    want = {name: _jax_two_device_step(*c[:-1]) for name, c in cases.items()}
    return want, ranks.join()


@pytest.mark.parametrize("case", ["vit", "vit_accum"])
def test_two_rank_step_matches_jax_two_device_step(runs, case):
    check_step(runs[0][case], [r[case] for r in runs[1]])
