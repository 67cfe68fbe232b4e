"""Evaluation CLI of the port (the JAX package's `tools/test.py`, on one device).

    python3 -m denseclip_vit_multimodal_tpu_torch.tools.test CONFIG CHECKPOINT \
        --aug-test --mode whole --eval mIoU depth

CHECKPOINT is a checkpoint file of the port's own format or a work dir
(its `checkpoints/latest`).  Predictions stay on the device (`fetch=
'device'`); the confusion matrix and the depth error sums accumulate there,
and only those small totals are read at the end.  The throughput clock starts
after the first batch, which pays the one-time set-up.  In slide mode, when
the config's crop differs from the reference protocol's, the reference
protocol is scored too (skip it with `--single-protocol`).  Runs on `cuda`
unless `--device cpu`.  Orbax checkpoints, `--shard-windows`, `--show-dir`,
`--out` and `--format-dir` are not ported yet.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate DenseCLIP (PyTorch port)")
    p.add_argument("config", help="config YAML path or preset name")
    p.add_argument("checkpoint", help="checkpoint file or work dir")
    p.add_argument("--eval", nargs="*", default=["mIoU"], help="metrics: mIoU, depth")
    p.add_argument("--mode", choices=["whole", "slide"], default="whole")
    # slide protocol defaults come from the config's `test:` section
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--stride", type=int, nargs=2, default=None)
    p.add_argument("--window-batch", type=int, default=None,
                   help="run the slide windows in chunks of this many")
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale (0.5-1.75) + flip logit averaging")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--single-protocol", action="store_true",
                   help="slide mode: skip the second pass at the reference protocol")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.data.loader import DataLoader, build_dataset
    from denseclip_vit_multimodal_tpu_torch.infer.engine import Inferencer
    from denseclip_vit_multimodal_tpu_torch.models.denseclip import build_denseclip
    from denseclip_vit_multimodal_tpu_torch.train.checkpoint import load_model_weights
    from denseclip_vit_multimodal_tpu_torch.train.loop import class_names_for
    from denseclip_vit_multimodal_tpu_torch.train.metrics import (
        accuracy_from_confusion,
        finalize_depth_errors,
        miou_from_confusion,
    )

    cfg = load_config(resolve_config_path(args.config), overrides=args.overrides)
    args.crop, args.stride, args.window_batch = resolve_test_protocol(
        cfg, args.crop, args.stride, args.window_batch)
    data_cfg = cfg.get("data", {}) or {}
    class_names = class_names_for(data_cfg)
    tpu_cfg = cfg.get("tpu", {}) or {}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(tpu_cfg.get("compute_dtype", "bfloat16"))]
    model, texts = build_denseclip(cfg.model, class_names, dtype=dtype,
                                   attn_impl=str(tpu_cfg.get("attn_impl", "auto")),
                                   device=args.device)
    epoch = load_model_weights(args.checkpoint, model)
    print(f"restored checkpoint at epoch {epoch}")
    aug_cfg = augment_config_from_data_cfg(data_cfg, train=False)
    loader = DataLoader(build_dataset(data_cfg, "val"), batch_size=args.batch_size,
                        shuffle=False, drop_last=False)
    infer = Inferencer(model, texts, aug_cfg, num_classes=len(class_names))
    max_depth = float(data_cfg.get("depth_max", 80.0))

    def evaluate(crop, stride, window_batch):
        cm = d_sums = d_count = out = None
        seen = seen_at_t0 = 0
        t0 = time.perf_counter()
        kw = dict(mode=args.mode, crop=tuple(crop), stride=tuple(stride),
                  window_batch=window_batch, fetch="device")

        def drain():
            # wait for everything queued so far by reading a small total
            if cm is not None:
                cm.sum().item()
            if d_count is not None:
                d_count.item()
            if cm is None and d_count is None:
                out["seg"].flatten()[0].item()

        for batch in loader.epoch(0):
            out = (infer.aug_test(batch["image"], **kw) if args.aug_test
                   else infer.predict(batch["image"], **kw))
            if "seg" in batch or "depth" in batch:
                c, s, n = infer.eval_metrics(out, seg_gt=batch.get("seg"),
                                             depth_gt=batch.get("depth"),
                                             ignore_index=aug_cfg.ignore_index,
                                             max_depth=max_depth)
                if c is not None:
                    cm = c if cm is None else cm + c
                if s is not None:
                    if d_sums is None:
                        d_sums, d_count = s, n
                    else:
                        d_sums = {k: d_sums[k] + s[k] for k in d_sums}
                        d_count = d_count + n
            seen += batch["image"].shape[0]
            if seen_at_t0 == 0:
                # the first batch pays the set-up: restart the clock after it
                drain()
                seen_at_t0 = seen
                t0 = time.perf_counter()
            if args.max_samples and seen >= args.max_samples:
                break

        results = {}
        if seen:
            drain()
        t_end = time.perf_counter()
        if seen > seen_at_t0:
            dt = t_end - t0
            results["images_per_sec"] = (seen - seen_at_t0) / dt if dt > 0 else float("inf")
        if cm is not None and "mIoU" in args.eval:
            miou, per_class = miou_from_confusion(cm)
            results["mIoU"] = float(miou)
            results["pixel_acc"] = float(accuracy_from_confusion(cm))
            for name, iou in zip(class_names, per_class.tolist()):
                results[f"iou/{name}"] = float(iou)
        if d_sums is not None:
            results.update({f"depth/{k}": float(v)
                            for k, v in finalize_depth_errors(d_sums, d_count).items()})
        return results

    results = evaluate(args.crop, args.stride, args.window_batch)
    for k, v in results.items():
        print(f"{k}: {v:.4f}")

    # When the config's slide crop departs from the reference protocol, score
    # the reference protocol too, so that a protocol change can never hide a
    # metric shift.
    test_cfg = cfg.get("test", {}) or {}
    ref_crop = list(test_cfg.get("reference_crop", [640, 640]))
    ref_stride = list(test_cfg.get("reference_stride", [426, 426]))
    if args.mode == "slide" and not args.single_protocol and list(args.crop) != ref_crop:
        print(f"--- reference protocol (crop {ref_crop[0]}x{ref_crop[1]}, "
              f"stride {ref_stride[0]}x{ref_stride[1]}) ---")
        ref_results = evaluate(ref_crop, ref_stride, args.window_batch)
        for k, v in ref_results.items():
            print(f"ref/{k}: {v:.4f}")
        results.update({f"ref/{k}": v for k, v in ref_results.items()})
        if "mIoU" in results and "ref/mIoU" in results:
            delta = results["mIoU"] - results["ref/mIoU"]
            print(f"protocol_delta_mIoU: {delta:+.4f}")
            results["protocol_delta_mIoU"] = delta
    return results


if __name__ == "__main__":
    main()
