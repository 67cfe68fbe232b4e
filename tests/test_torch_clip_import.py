"""CLIP and reference-checkpoint import of the port against the JAX
package's, on the CPU.

A stub OpenAI CLIP file (the state-dict layout of `tests/test_clip_import.py`'s
`TorchCLIPRoot`: `visual.*` tower plus text-tower keys at the root) goes
through the JIT route and the pickle route; the JAX package imports it into
its variables (`load_clip_into_variables`), the port into a model holding
the same initial weights (`convert.load_flax_variables`).  Both results must
be equal bit for bit, and the resized pos-embed within 1e-6 either way.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn
import yaml

import jax
import jax.numpy as jnp

from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import clip_import as j_ci
from denseclip_vit_multimodal_tpu.train import weights as j_weights
from denseclip_vit_multimodal_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip as t_build
from denseclip_vit_multimodal_tpu_torch.train import clip_import as t_ci
from denseclip_vit_multimodal_tpu_torch.train import weights as t_weights
from torch_clip_files import reference_state

WIDTH, LAYERS, HEADS, PATCH, RES = 64, 3, 4, 8, 32  # base grid 4 x 4
TWIDTH, TLAYERS, THEADS, TEMBED = 48, 2, 4, 24

MODEL_CFG = {
    "type": "DenseCLIP", "text_dim": TEMBED, "context_length": 5, "token_embed_dim": TWIDTH,
    "context_feature": "attention", "score_concat_index": -1, "tau": 0.05,
    "backbone": {"type": "CLIPVisionTransformer", "patch_size": PATCH, "width": WIDTH,
                 "layers": LAYERS, "heads": HEADS, "input_resolution": RES,
                 "output_dim": WIDTH, "out_indices": [0, 1, 2]},
    "text_encoder": {"type": "CLIPTextContextEncoder", "context_length": 13, "vocab_size": 49408,
                     "transformer_width": TWIDTH, "transformer_heads": THEADS,
                     "transformer_layers": TLAYERS, "embed_dim": TEMBED},
    "neck": {"type": "ViTFeatureFusionNeck", "inter_channels": 16, "out_channels": 32},
    "decode_head": {"type": "FPNHead", "in_channels": 32, "channels": 32, "num_classes": 19,
                    "dropout_ratio": 0.0},
    "depth_head": {"type": "FCNHeadDepth", "in_channels": 32, "channels": 16,
                   "dropout_ratio": 0.0},
}
IMG = np.random.RandomState(0).rand(1, 32, 64, 3).astype(np.float32)


class _Attn(tnn.Module):
    def __init__(self, d):
        super().__init__()
        self.in_proj_weight = tnn.Parameter(torch.randn(3 * d, d) * 0.02)
        self.in_proj_bias = tnn.Parameter(torch.randn(3 * d) * 0.02)
        self.out_proj = tnn.Linear(d, d)


class _Block(tnn.Module):
    def __init__(self, d):
        super().__init__()
        self.ln_1, self.ln_2 = tnn.LayerNorm(d), tnn.LayerNorm(d)
        self.attn = _Attn(d)
        self.mlp = tnn.Sequential()
        self.mlp.add_module("c_fc", tnn.Linear(d, d * 4))
        self.mlp.add_module("c_proj", tnn.Linear(d * 4, d))


class _Tower(tnn.Module):
    def __init__(self, d, layers):
        super().__init__()
        self.resblocks = tnn.ModuleList([_Block(d) for _ in range(layers)])


class StubCLIP(tnn.Module):
    """OpenAI CLIP's state-dict layout, random weights."""

    def __init__(self):
        super().__init__()
        grid = RES // PATCH
        self.visual = tnn.Module()
        self.visual.conv1 = tnn.Conv2d(3, WIDTH, PATCH, PATCH, bias=False)
        self.visual.class_embedding = tnn.Parameter(torch.randn(WIDTH) * 0.02)
        self.visual.positional_embedding = tnn.Parameter(torch.randn(grid * grid + 1, WIDTH) * 0.02)
        self.visual.ln_pre, self.visual.ln_post = tnn.LayerNorm(WIDTH), tnn.LayerNorm(WIDTH)
        self.visual.proj = tnn.Parameter(torch.randn(WIDTH, 512) * 0.02)
        self.visual.transformer = _Tower(WIDTH, LAYERS)
        self.transformer = _Tower(TWIDTH, TLAYERS)
        self.token_embedding = tnn.Embedding(49408, TWIDTH)
        self.positional_embedding = tnn.Parameter(torch.randn(77, TWIDTH) * 0.01)
        self.ln_final = tnn.LayerNorm(TWIDTH)
        self.text_projection = tnn.Parameter(torch.randn(TWIDTH, TEMBED) * 0.02)
        with torch.no_grad():  # LayerNorms away from their (1, 0) init, so a misplaced one shows
            for m in self.modules():
                if isinstance(m, tnn.LayerNorm):
                    m.weight.add_(torch.randn_like(m.weight) * 0.1)
                    m.bias.add_(torch.randn_like(m.bias) * 0.1)

    def forward(self):
        return self.text_projection


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same weights as a TorchScript archive, a pickled fp16 state_dict
    (as released: fp16) and a pickled module."""
    torch.manual_seed(3)
    root = StubCLIP().eval()
    folder = tmp_path_factory.mktemp("clip")
    root = root.half().float()  # exactly representable in fp16
    paths = {"jit": str(folder / "jit.pt"), "pickle_fp16": str(folder / "fp16.pt"),
             "pickle_module": str(folder / "module.pt")}
    torch.jit.save(torch.jit.script(root), paths["jit"])
    torch.save({k: v.half() for k, v in root.state_dict().items()}, paths["pickle_fp16"])
    torch.save(root, paths["pickle_module"])
    return paths, {k: v.detach().clone() for k, v in root.state_dict().items()}


@pytest.fixture(scope="module")
def jax_init():
    jm, texts = j_build(MODEL_CFG, CITYSCAPES_CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(IMG), jnp.asarray(texts))
    return jm, texts, jax.tree.map(np.asarray, variables)


def _port_model(variables):
    model, texts = t_build(MODEL_CFG, CITYSCAPES_CLASSES, device="cpu")
    load_flax_variables(model, variables)
    return model, texts


@pytest.mark.parametrize("route", ["jit", "pickle_fp16", "pickle_module"])
def test_load_clip_state_dict_routes(archives, route):
    paths, want = archives
    state = t_ci.load_clip_state_dict(paths[route])
    assert sorted(state) == sorted(want)
    for key, value in want.items():
        assert state[key].dtype == torch.float32
        assert torch.equal(state[key], value), key
    j_state = j_ci.load_clip_state_dict(paths[route])
    for key in want:
        np.testing.assert_array_equal(state[key].numpy(), j_state[key])


@pytest.mark.parametrize("route", ["jit", "pickle_fp16"])
def test_clip_import_matches_jax_bitwise(archives, jax_init, route):
    paths, _ = archives
    jm, texts, variables = jax_init
    loaded, j_vis, j_txt = j_ci.load_clip_into_variables(variables, paths[route], MODEL_CFG)
    want = flax_to_state_dict(jax.tree.map(np.asarray, loaded))
    model, _ = _port_model(variables)
    n_vis, n_txt = t_ci.load_clip_into_model(model, paths[route], MODEL_CFG)
    assert (n_vis, n_txt) == (12 * LAYERS + 8, 12 * TLAYERS + 5)
    got = model.state_dict()
    assert set(want) == {k for k in got if not k.endswith("num_batches_tracked")}
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # the importer wrote the archive, not the init: pos-embed truncated 77 -> 13, proj taken
    assert not torch.equal(got["backbone.ln_post.weight"],
                           flax_to_state_dict(variables)["backbone.ln_post.weight"])


def test_tiny_flagship_forward_matches_jax_after_import(archives, jax_init):
    paths, _ = archives
    jm, texts, variables = jax_init
    loaded, _, _ = j_ci.load_clip_into_variables(variables, paths["jit"], MODEL_CFG)
    want = jm.apply(loaded, jnp.asarray(IMG), jnp.asarray(texts))
    model, t_texts = _port_model(variables)
    t_ci.load_clip_into_model(model, paths["jit"], MODEL_CFG)
    with torch.no_grad():
        got = model(torch.from_numpy(IMG), t_texts)
    for key in ("seg", "depth"):
        a, b = got[key].numpy(), np.asarray(want[key])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-5, key


@pytest.mark.parametrize("grid_from,grid_to", [(4, 8), (8, 4), (14, 39), (14, 5)])
def test_pos_embed_resize_matches_jax(grid_from, grid_to):
    pos = np.random.RandomState(grid_to).randn(grid_from * grid_from + 1, 16).astype(np.float32)
    want = j_ci._resize_grid_pos_embed(pos, (grid_to, grid_to))
    got = t_ci._resize_grid_pos_embed(torch.from_numpy(pos), grid_to).numpy()
    assert got.shape == want.shape == (grid_to * grid_to + 1, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0], pos[0])


def test_vit_import_at_another_grid_and_proj_shape(archives):
    _, root = archives
    state = {k: v for k, v in root.items()}
    np_state = {k: v.numpy() for k, v in state.items()}
    want = j_ci.import_vit_params(np_state, layers=LAYERS, base_grid=8, clip_proj_dim=256)
    got = t_ci.import_vit_state(state, layers=LAYERS, base_grid=8, proj_shape=(WIDTH, 256))
    assert "proj" not in got and "proj" not in want  # shape mismatch: left at init
    np.testing.assert_allclose(got["positional_embedding"].numpy(),
                               want["positional_embedding"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["patch_embed.weight"].numpy(), want["patch_embed"].T)
    text = t_ci.import_text_state(state, layers=TLAYERS, context_length=22, embed_dim=TEMBED + 1)
    assert "text_projection" not in text and text["positional_embedding"].shape == (22, TWIDTH)
    with pytest.raises(ValueError, match="pos-embed 77 < model capacity 78"):
        t_ci.import_text_state(state, layers=TLAYERS, context_length=78, embed_dim=TEMBED)


def _reference_state(model_state, clip_state, rs):
    """A reference DenseCLIP state_dict (the reference trainer's names): the
    towers from the CLIP archive, every other module random."""
    random = {}
    for key, value in model_state.items():
        if key.endswith("num_batches_tracked"):
            random[key] = np.asarray(5, np.int64)
            continue
        noise = rs.randn(*value.shape).astype(np.float32)
        random[key] = np.abs(noise) + 0.5 if key.endswith("running_var") else noise
    ref = reference_state(clip_state, random)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in ref.items()}


def test_reference_import_matches_jax_bitwise(archives, jax_init):
    _, clip_state = archives
    jm, texts, variables = jax_init
    model, _ = _port_model(variables)
    ref = _reference_state(model.state_dict(), clip_state, np.random.RandomState(5))
    ref["gamma"] = np.full((TEMBED,), 1e-4, np.float32)
    loaded = j_ci.import_reference_denseclip(dict(ref), variables)
    loaded["params"].pop("gamma")  # the JAX tree grows a leaf no module reads
    want = flax_to_state_dict(jax.tree.map(np.asarray, loaded))
    written = t_ci.import_reference_denseclip(ref, model)
    got = model.state_dict()
    assert "gamma" not in got and written == len(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert torch.equal(got["neck.fuse.bn.running_var"], torch.from_numpy(ref["neck.fusion_layer.1.running_var"]))


def test_reference_import_refuses_what_is_not_ported(archives, jax_init):
    _, clip_state = archives
    model, _ = _port_model(jax_init[2])
    ref = _reference_state(model.state_dict(), clip_state, np.random.RandomState(6))
    with pytest.raises(ValueError, match="models/context_decoder.py"):
        t_ci.import_reference_denseclip({**ref, "context_decoder.memory_proj.0.weight":
                                         np.ones(4, np.float32)}, model)
    resnet = {k: v for k, v in ref.items() if not k.startswith("backbone.")}
    resnet["backbone.conv1.weight"] = np.ones((8, 3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="models/resnet.py"):
        t_ci.import_reference_denseclip(resnet, model)
    with pytest.raises(ValueError, match="shape mismatch for neck.fuse.conv.weight"):
        t_ci.import_reference_denseclip({**ref, "neck.fusion_layer.0.weight":
                                         np.ones((1, 1, 1, 1), np.float32)}, model)


def test_clip_import_refuses_a_resnet_archive(tmp_path):
    path = str(tmp_path / "RN50.pt")
    torch.save({"visual.conv1.weight": torch.ones(32, 3, 3, 3).half()}, path)
    model, _ = t_build(MODEL_CFG, CITYSCAPES_CLASSES, device="cpu")
    with pytest.raises(ValueError, match="models/resnet.py"):
        t_ci.load_clip_into_model(model, path, MODEL_CFG)


def test_import_checkpoint_cli_matches_jax(archives, jax_init, tmp_path):
    """The port's CLI and the JAX package's on one reference trainer file
    (`module.` prefixes, epoch, best metric): the same tensors, restored."""
    from denseclip_vit_multimodal_tpu.train.checkpoint import restore_checkpoint
    from denseclip_vit_multimodal_tpu.train.state import create_train_state as j_state
    from denseclip_vit_multimodal_tpu_torch.tools import import_checkpoint as t_cli
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from tools import import_checkpoint as j_cli

    _, clip_state = archives
    jm, texts, variables = jax_init
    model, _ = _port_model(variables)
    ref = _reference_state(model.state_dict(), clip_state, np.random.RandomState(7))
    pth = tmp_path / "ref.pth"
    torch.save({"epoch": 7, "best_metric": 0.5,
                "state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()}},
               str(pth))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": MODEL_CFG, "training": {"batch_size": 2},
                                        "tpu": {"compute_dtype": "float32"}}))
    j_cli.main([str(cfg_path), str(pth), "--out", str(tmp_path / "jax")])
    path = t_cli.main([str(cfg_path), str(pth), "--out", str(tmp_path / "port"),
                       "--device", "cpu"])
    assert path.endswith("epoch_7.pt")

    state, epoch, best = restore_checkpoint(str(tmp_path / "jax"),
                                            j_state(jm, variables, {}, 1))
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, state.params),
                               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    restored, _ = t_build(MODEL_CFG, CITYSCAPES_CLASSES, device="cpu", seed=11)
    assert load_model_weights(str(tmp_path / "port"), restored, which="best") == epoch == 7
    got = restored.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 0 and payload["best_metric"] == pytest.approx(best)


def test_ensure_weights_never_fetches_what_exists(tmp_path, monkeypatch):
    """The URL table is the JAX package's; an existing file is returned as
    it is; a known missing name is fetched once (the fetch is patched: the
    tests reach no network); a failed fetch or an unknown name gives None."""
    assert t_weights.CLIP_URLS == j_weights.CLIP_URLS
    calls = []

    def fake_fetch(url, dst, timeout=60.0):
        calls.append(url)
        with open(dst, "wb") as f:
            f.write(b"weights")

    monkeypatch.setattr(t_weights, "_fetch", fake_fetch)
    have = tmp_path / "mine.pt"
    have.write_bytes(b"x")
    assert t_weights.ensure_weights(str(have)) == str(have) and not calls
    want = tmp_path / "pretrained" / "ViT-B-16.pt"
    assert t_weights.ensure_weights(str(want)) == str(want)
    assert calls == [t_weights.CLIP_URLS["ViT-B-16.pt"]] and want.read_bytes() == b"weights"
    assert t_weights.ensure_weights(str(tmp_path / "ViT-H-14.pt")) is None

    def failing(url, dst, timeout=60.0):
        with open(dst, "wb") as f:
            f.write(b"part")
        raise OSError("unreachable")

    monkeypatch.setattr(t_weights, "_fetch", failing)
    gone = tmp_path / "RN50.pt"
    assert t_weights.ensure_weights(str(gone)) is None
    assert not gone.exists() and not (tmp_path / "RN50.pt.part").exists()
