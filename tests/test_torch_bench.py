"""The port's measuring modules on the CPU at tiny widths: `bench.py`, the
bench suite, `tools/get_flops.py` and `utils/env.py` (with `--deterministic`
of `tools/train.py`), against the JAX package where it computes the same."""

import glob
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseclip_vit_multimodal_tpu.core.config import load_config as j_load_config
from denseclip_vit_multimodal_tpu.infer.engine import Inferencer as JInferencer
from denseclip_vit_multimodal_tpu.infer.slide import slide_inference as j_slide_inference
from denseclip_vit_multimodal_tpu.models.denseclip import build_denseclip as j_build
from denseclip_vit_multimodal_tpu.train import metrics as j_metrics
from denseclip_vit_multimodal_tpu.train.state import count_params as j_count_params
from denseclip_vit_multimodal_tpu_torch import bench
from denseclip_vit_multimodal_tpu_torch.convert import load_flax_variables
from denseclip_vit_multimodal_tpu_torch.models.denseclip import CITYSCAPES_CLASSES
from denseclip_vit_multimodal_tpu_torch.tools import bench_suite, get_flops
from denseclip_vit_multimodal_tpu_torch.tools import train as train_cli
from denseclip_vit_multimodal_tpu_torch.utils import env

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs/denseclip_vitb16_cityscapes_multitask.yaml")
# the tiny widths of the verify recipe, in fp32
TINY = ["model.backbone.width=96", "model.backbone.layers=4", "model.backbone.heads=3",
        "model.backbone.out_indices=[0,1,2,3]", "model.text_encoder.transformer_layers=2",
        "model.neck.inter_channels=32", "model.neck.out_channels=64",
        "model.decode_head.in_channels=64", "model.decode_head.channels=64",
        "model.depth_head.in_channels=64", "model.depth_head.channels=32",
        "tpu.compute_dtype=float32"]
TOL = 1e-4  # fp32 end to end, as tests/test_torch_infer.py
MFU_KEYS = {"model_tflops_per_image", "mfu_pct", "peak_bf16_tflops"}
SUITE_ARGS = ["--device", "cpu", "--image", "128", "256", "--crop", "64", "64", "--stride",
              "48", "48", "--iters", "1", "--rounds", "1",
              "--set", *TINY, "data.crop_size=[64,128]"]
SUITE_METRICS = ["vit16_512x512_seg_forward", "slide_1024x2048_multitask",
                 "slide_1024x2048_multitask_batch4", "whole_1024x2048_multitask_batch4",
                 "train_step_frozen_text_batch16", "train_step_unfrozen_backbone_batch8",
                 "loader_host_pipeline_batch16", "loader_host_machinery_batch16",
                 "train_loader_included_batch16", "eval_path_device_1024x2048_slide",
                 "aug_test_slide_3scale_flip_1024x2048"]


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model of the tiny config with initialised weights (random
    BatchNorm statistics, so that they matter) as numpy."""
    cfg = j_load_config(CONFIG, overrides=TINY)
    model, texts = j_build(cfg.model, CITYSCAPES_CLASSES)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 96, 3), jnp.float32), jnp.asarray(texts))
    rs = np.random.RandomState(3)
    variables = {
        "params": jax.tree.map(np.asarray, variables["params"]),
        "batch_stats": jax.tree.map(lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
                                    variables["batch_stats"]),
    }
    return model, texts, variables


def test_bench_main_prints_one_line_without_mfu_on_the_cpu(capsys):
    line = bench.main(["--device", "cpu", "--image", "128", "256", "--iters", "2",
                       "--rounds", "2", "--set", *TINY])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["metric"] == "cityscapes_1024x2048_slide_infer_images_per_sec_per_chip"
    assert {"value", "unit", "value_reference_protocol", "crop_shipped", "crop_reference",
            "latency_ms_p50", "latency_ms_p90", "latency_samples", "timed_runs", "drift_pct",
            "device", "power_limit_w"} <= set(line)
    assert not MFU_KEYS & set(line) and "vs_baseline" not in line
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["crop_shipped"] == [624, 624] and line["crop_reference"] == [640, 640]
    assert line["value"] > 0 and line["value_reference_protocol"] > 0
    assert line["latency_samples"] == 2 * line["timed_runs"]
    assert 0 < line["latency_ms_p50"] <= line["latency_ms_p90"]


def test_bench_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bench.main([])
    with pytest.raises(SystemExit):
        bench_suite.main(["--out", "bench_suite_results_torch_never_written.json"])
    assert not os.path.exists("bench_suite_results_torch_never_written.json")


def test_bench_frame_matches_jax_slide_inference(jax_model):
    """The frame the bench times (crop 624, stride 426: two windows of a
    624 x 680 frame) equals the JAX package's slide inference of the same
    frame on the same weights."""
    model, texts, variables = jax_model
    args = bench.parse_args(["--device", "cpu", "--image", "624", "680", "--set", *TINY])
    engine, frame_fn = bench.setup(args)
    load_flax_variables(engine.model, variables)
    got = frame_fn(bench.CROP_SHIPPED)()
    frame = np.random.RandomState(bench.SEED).randint(0, 255, (1, 624, 680, 3), dtype=np.uint8)
    j_engine = JInferencer(model, variables, texts, num_classes=19, with_depth=True)
    want = j_engine.predict(frame, mode="slide", crop=bench.CROP_SHIPPED, stride=bench.STRIDE)
    np.testing.assert_allclose(got["seg_logits"].numpy(), want["seg_logits"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def suite_run(tmp_path_factory):
    """The suite at tiny widths on one intra-op thread: its device-timed
    workloads run thousands of small operators, and with a thread a core on
    a machine whose cores other processes keep busy each of them waits for
    its slowest thread (the suite took 30x its time alone there)."""
    out = tmp_path_factory.mktemp("suite") / "results.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = bench_suite.main([*SUITE_ARGS, "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    return results, out


@pytest.mark.parametrize("metric", SUITE_METRICS)
def test_suite_workload_runs_on_the_cpu_under_jax_names(suite_run, metric):
    """All nine workloads run at tiny widths (the training ones take their
    steps at JAX's batch sizes, 16 and 8), each a positive rate."""
    results, _ = suite_run
    line = {r["metric"]: r for r in results}[metric]
    assert line["value"] > 0 and line["device"] == "cpu" and line["timed_runs"] >= 1
    assert line["unit"] in ("images/sec", "samples/sec")


def test_suite_results_file_and_cpu_lines(suite_run):
    results, out = suite_run
    assert [r["metric"] for r in results] == SUITE_METRICS  # JAX's order of execution
    assert json.loads(out.read_text()) == sorted(results, key=lambda r: [
        name.format(arch="vit16", task="multitask")
        for name in bench_suite.ORDER].index(r["metric"]))
    assert not any(r["metric"].endswith("_mfu") for r in results)  # no peak on the CPU


@pytest.mark.parametrize("tag", ["", "_int8", "_fused", "_rn50", "_rn101", "_vitl14",
                                 "_ade20k", "_after_int32_cm"])
def test_suite_results_never_land_in_a_jax_file(tag):
    jax_files = {os.path.basename(p) for p in glob.glob(str(ROOT / "bench_suite_results*.json"))}
    assert "bench_suite_results_rn50.json" in jax_files
    assert bench_suite.results_path(tag) not in jax_files
    assert bench_suite.parse_args(["--tag", tag]).out == bench_suite.results_path(tag)
    assert bench_suite.parse_args(["--attn-impl", "int8"]).out == \
        "bench_suite_results_torch_int8.json"
    with pytest.raises(SystemExit):
        bench_suite.parse_args(["--out", f"bench_suite_results{tag}.json"])


def test_suite_eval_fold_matches_jax(jax_model):
    """Workload 9's folded scalar (slide + argmax + confusion matrix + depth
    error sums) equals the same computation through the JAX package."""
    model, texts, variables = jax_model
    crop, stride, h, w = (64, 64), (48, 48), 128, 256
    args = bench.parse_args(["--device", "cpu", "--image", str(h), str(w), "--set", *TINY])
    engine, _ = bench.setup(args)
    load_flax_variables(engine.model, variables)
    rng = np.random.RandomState(0)
    im = rng.rand(1, h, w, 3).astype(np.float32)
    seg_gt = rng.randint(0, 19, (1, h, w)).astype(np.int32)
    depth_gt = rng.uniform(0, 80, (1, h, w)).astype(np.float32)
    eval_one = bench_suite.make_eval_one(engine, crop, stride, 0)
    with torch.inference_mode():
        got = float(eval_one(*(torch.from_numpy(a) for a in (im, seg_gt, depth_gt))))

    texts_j = jnp.asarray(texts)

    @jax.jit
    def j_eval_one(v, image, seg, depth):  # the JAX suite's eval_one
        cached = model.apply(v, texts_j, method="encode_text_base")

        def window_forward(win):
            out = model.apply(v, win, texts_j, train=False, resize_outputs=False,
                              cached_text=cached)
            return jnp.concatenate([out["seg"].astype(jnp.float32),
                                    out["depth"].astype(jnp.float32)], -1)

        logits = j_slide_inference(window_forward, image, 20, crop=crop, stride=stride)
        cm = j_metrics.confusion_matrix(jnp.argmax(logits[..., :19], axis=-1), seg, 19, 255)
        sums, count = j_metrics.depth_errors(logits[..., 19], depth, depth > 0, max_depth=80.0)
        return jnp.sum(cm) + count + sum(jnp.sum(s) for s in sums.values())

    want = float(j_eval_one(variables, im, seg_gt, depth_gt))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_get_flops_parameter_count_equals_jax(jax_model, capsys):
    _, _, variables = jax_model
    res = get_flops.main([CONFIG, "--device", "cpu", "--shape", "64", "128", "--set", *TINY])
    assert res["parameters"] == j_count_params(variables["params"])
    assert res["flops"] == res["aten_flops"] > 0 and res["kernel_flops"] == 0
    out = capsys.readouterr().out
    assert "parameters" in out and "aten-counted" in out and "hbm bytes" not in out


@pytest.fixture
def restore_determinism():
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.get_float32_matmul_precision(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]
    torch.set_float32_matmul_precision(saved[4])
    if saved[5] is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[5]


def test_set_determinism(restore_determinism):
    env.set_determinism()
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == env.CUBLAS_WORKSPACE


def test_train_cli_deterministic(restore_determinism, tmp_path):
    """`tools/train.py --deterministic` sets the determinism knobs and logs
    the environment report at the start of `train()`."""
    work = tmp_path / "wd"
    train_cli.main([CONFIG, "--device", "cpu", "--no-validate", "--max-steps", "1",
                    "--deterministic", "--work-dir", str(work), "--set", *TINY,
                    "model.text_encoder.vocab_size=512", "data.synthetic=true",
                    "data.synthetic_options.image_size=[64,128]",
                    "data.synthetic_options.length=2", "data.crop_size=[64,128]",
                    "training.batch_size=2", "training.workers=1"])
    assert torch.are_deterministic_algorithms_enabled()
    log = (work / "train.log").read_text()
    assert "environment:" in log and f"torch               : {torch.__version__}" in log


def test_seed_everything_returns_a_seeded_generator():
    gen = env.seed_everything(5)
    first = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
    gen = env.seed_everything(5)
    again = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
    assert first[0] == again[0]
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert torch.equal(first[2], torch.rand(2, generator=torch.Generator().manual_seed(5)))


def test_collect_env_info_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PATH", "")  # no nvidia-smi
    info = env.collect_env_info()
    assert f"torch               : {torch.__version__}" in info
    assert "cuda devices        : none" in info and "nvidia-smi" not in info
    assert env.nvidia_smi_cards() == []
    assert env.power_limit_watts("700.00 W") == 700.0
    assert env.power_limit_watts("[N/A]") is None


def test_profiler_trace_and_step_timer(tmp_path):
    with env.profiler_trace(None):
        pass  # no-op
    with env.profiler_trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert list(tmp_path.iterdir())  # a trace file
    timer = env.StepTimer(window=2)
    assert timer.tick() is None and timer.mean == 0.0 and timer.steps_per_sec() == 0.0
    for _ in range(3):
        assert timer.tick() >= 0.0
    assert len(timer._times) == 2 and timer.steps_per_sec() > 0
