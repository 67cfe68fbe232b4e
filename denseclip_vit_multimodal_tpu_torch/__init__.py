"""denseclip_vit_multimodal_tpu_torch — the PyTorch/CUDA port of DenseCLIP seg+depth.

A second package beside the JAX reference `denseclip_vit_multimodal_tpu`.
It imports torch, numpy and yaml, and nothing of JAX or of the JAX package.
Plain tensor work is PyTorch; the TPU kernels become kernels written by hand
for NVIDIA Hopper (sources under `csrc/`, built at first use).

Top-level API (lazily imported):

    load_config / resolve_config_path  — YAML config system
    build_denseclip                    — config dict -> (model on a device, texts)
    Inferencer                         — whole / slide inference engine
    load_flax_variables                — carry JAX weights into a port model
"""

__version__ = "0.1.0"

_LAZY = {
    "load_config": "denseclip_vit_multimodal_tpu_torch.core.config",
    "resolve_config_path": "denseclip_vit_multimodal_tpu_torch.core.config",
    "build_denseclip": "denseclip_vit_multimodal_tpu_torch.models.denseclip",
    "CITYSCAPES_CLASSES": "denseclip_vit_multimodal_tpu_torch.models.denseclip",
    "Inferencer": "denseclip_vit_multimodal_tpu_torch.infer.engine",
    "load_flax_variables": "denseclip_vit_multimodal_tpu_torch.convert",
    "tokenize": "denseclip_vit_multimodal_tpu_torch.text.tokenizer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
