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
unless `--device cpu`.

On the primary protocol pass only, as in the JAX package: `--show-dir DIR`
writes a panel per frame (`frame_00000.png`, ... through
`utils/visualize.py::save_multi_task_panel`, titled `frame N`); `--out
FILE.npz` saves every frame's prediction in one `np.savez_compressed`
(`seg_N` uint8, `depth_N` float16); `--format-dir DIR` writes Cityscapes
submission PNGs (`frame_00000_labelIds.png`, 8-bit gray, trainId ->
labelId by `data/cityscapes.py::labelids_from_trainids`).  These fetch each
batch's predictions to the host.  `--fetch-logits` also copies the fp32
logit canvas to the host every batch.  `--shard-windows` runs unsharded,
with a warning, on one device (or outside slide mode); spreading windows
over several devices is not ported (parallelism) and raises.  Orbax
checkpoints are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys
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
    p.add_argument("--shard-windows", action="store_true",
                   help="slide mode: spread each frame's windows over the devices "
                        "(one device: runs unsharded with a warning)")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--fetch-logits", action="store_true",
                   help="also copy the fp32 logit canvas to the host every batch")
    p.add_argument("--show-dir", default=None, metavar="DIR",
                   help="save an input / prediction (/ ground truth) panel PNG per frame")
    p.add_argument("--out", default=None, metavar="FILE.npz",
                   help="save every frame's prediction (uint8 seg, float16 depth) to one "
                        ".npz, keys seg_N / depth_N")
    p.add_argument("--format-dir", default=None, metavar="DIR",
                   help="write the predictions as Cityscapes submission labelId PNGs, "
                        "named by dataset order")
    p.add_argument("--single-protocol", action="store_true",
                   help="slide mode: skip the second pass at the reference protocol")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   metavar="KEY.PATH=VALUE", help="dotted config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from denseclip_vit_multimodal_tpu_torch.core.config import (
        load_config,
        resolve_config_path,
        resolve_test_protocol,
    )
    from denseclip_vit_multimodal_tpu_torch.data.augment import augment_config_from_data_cfg
    from denseclip_vit_multimodal_tpu_torch.data.cityscapes import labelids_from_trainids
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
    from denseclip_vit_multimodal_tpu_torch.utils.png import encode_png
    from denseclip_vit_multimodal_tpu_torch.utils.visualize import save_multi_task_panel

    if args.shard_windows:
        devices = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
        if args.mode == "slide" and devices > 1:
            raise NotImplementedError(
                f"--shard-windows over {devices} devices is not ported yet (parallelism, "
                "ROADMAP §1 item 6)")
        print("WARNING: --shard-windows needs --mode slide and >1 device; running unsharded",
              file=sys.stderr)
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

    def save_artifacts(batch, out, seen: int, out_arrays: dict) -> None:
        """--show-dir / --out / --format-dir for one batch (a host fetch)."""
        seg_np = out["seg"].to(torch.int32).cpu().numpy()
        depth_np = out["depth"].float().cpu().numpy() if "depth" in out else None
        for b in range(seg_np.shape[0]):
            idx = seen + b
            if args.show_dir:
                save_multi_task_panel(
                    os.path.join(args.show_dir, f"frame_{idx:05d}.png"), batch["image"][b],
                    seg_np[b], seg_gt=batch["seg"][b] if "seg" in batch else None,
                    depth_pred=depth_np[b] if depth_np is not None else None,
                    depth_gt=batch["depth"][b] if "depth" in batch else None,
                    max_depth=max_depth, title=f"frame {idx}")
            if args.out:
                out_arrays[f"seg_{idx}"] = seg_np[b].astype(np.uint8)
                if depth_np is not None:
                    out_arrays[f"depth_{idx}"] = depth_np[b].astype(np.float16)
            if args.format_dir:
                os.makedirs(args.format_dir, exist_ok=True)
                with open(os.path.join(args.format_dir, f"frame_{idx:05d}_labelIds.png"),
                          "wb") as f:
                    f.write(encode_png(labelids_from_trainids(seg_np[b])))

    def evaluate(crop, stride, window_batch, artifacts=False):
        cm = d_sums = d_count = out = None
        out_arrays = {}  # --out: uint8 seg / float16 depth per frame
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
            if args.fetch_logits:
                out["seg_logits"].float().cpu().numpy()  # the opt-in canvas copy
            if artifacts and (args.show_dir or args.out or args.format_dir):
                save_artifacts(batch, out, seen, out_arrays)
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
        if artifacts and args.out and out_arrays:
            np.savez_compressed(args.out, **out_arrays)
            print(f"saved {sum(k.startswith('seg') for k in out_arrays)} frames to {args.out}")
        return results

    results = evaluate(args.crop, args.stride, args.window_batch, artifacts=True)
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
