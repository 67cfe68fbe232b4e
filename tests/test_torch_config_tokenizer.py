"""The port's own copies of the config system and tokenizer agree with the JAX package's."""

import numpy as np
import pytest

from denseclip_vit_multimodal_tpu.core import config as jax_config
from denseclip_vit_multimodal_tpu.text import tokenizer as jax_tokenizer
from denseclip_vit_multimodal_tpu_torch.core import config as port_config
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.text import tokenizer as port_tokenizer

FLAGSHIP = "configs/denseclip_vitb16_cityscapes_multitask.yaml"
OVERRIDES = ["model.backbone.layers=4", "training.optimizer.lr=1e-4", "test.window_batch=10"]


@pytest.mark.parametrize("overrides", [None, OVERRIDES], ids=["plain", "overrides"])
def test_flagship_config_matches(overrides):
    port = port_config.load_config(port_config.resolve_config_path(FLAGSHIP), overrides)
    ref = jax_config.load_config(jax_config.resolve_config_path(FLAGSHIP), overrides)
    assert port.to_dict() == ref.to_dict()
    assert port_config.resolve_test_protocol(port) == jax_config.resolve_test_protocol(ref)
    window_batch = 20 if overrides is None else 10
    assert port_config.resolve_test_protocol(port) == ([624, 624], [426, 426], window_batch)


def test_override_errors_match():
    with pytest.raises(ValueError):
        port_config.apply_overrides({}, ["no_equals_sign"])


@pytest.mark.parametrize("context_length", [6, 77])
def test_class_name_tokens_match(context_length):
    names = list(CITYSCAPES_CLASSES)
    port = port_tokenizer.tokenize(names, context_length=context_length)
    ref = jax_tokenizer.tokenize(names, context_length=context_length)
    assert port.dtype == np.int32 and port.shape == (19, context_length)
    np.testing.assert_array_equal(port, ref)


def test_tokenizer_overflow_raises():
    with pytest.raises(RuntimeError):
        port_tokenizer.tokenize("a photo of a cat", context_length=4)
    out = port_tokenizer.tokenize("a photo of a cat", context_length=4, truncate=True)
    np.testing.assert_array_equal(
        out, jax_tokenizer.tokenize("a photo of a cat", context_length=4, truncate=True))
