"""CLI entry point: run SLAM over a dataset and export the results (port of
``mast3r_slam_tpu/slam/run.py``).

    python -m mast3r_slam_tpu_torch.slam.run --dataset datasets/tum/rgbd_dataset_freiburg1_room \\
        --config eval_no_calib --checkpoint checkpoints/MASt3R....pth

The JAX CLI's flags and outputs: under ``logs/<save-as>/`` (``logs/`` for
the default), ``<seq>.txt`` (the keyframe trajectory, TUM format),
``<seq>.ply``, ``keyframes/<seq>/<timestamp>.png``, ``<seq>_map.png`` and
``<seq>_scene.json``.  ``--checkpoint`` takes a converted ``.npz`` or a
released ``.pth``; without one the weights are random (seed 0).
``--device`` replaces the JAX CLI's ``--platform`` (the card by default;
``cpu`` to run on the CPU); ``--trace DIR`` writes a torch.profiler trace;
``--set`` values parse as YAML scalars (``utils/yaml_subset.py``).
``--viz-ws PORT`` streams the run's events to viewers on
``ws://127.0.0.1:PORT`` (``serve/broadcast.py``; 0, the default, is off),
whose run control (pause, step, terminate) the run obeys and whose
confidence threshold the PLY export takes.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch


def build_model(cfg, img_hw, checkpoint=None, seed=0, preset="vit_large", device=None):
    """The model for ``img_hw`` under ``cfg``'s engine dtypes: from
    ``checkpoint`` (``.npz`` or ``.pth``), or random weights from ``seed``."""
    from ..models import mast3r as M
    from ..models.interface import MASt3RModel

    engine = cfg.get("engine", {})
    mcfg = M.VIT_LARGE if preset == "vit_large" else M.VIT_TINY_TEST
    if preset == "vit_large" and engine.get("dtype", "bfloat16") == "float32":
        mcfg = dataclasses.replace(mcfg, dtype=torch.float32)
    if engine.get("head_dtype", "float32") == "bfloat16":
        mcfg = dataclasses.replace(mcfg, head_dtype=torch.bfloat16)
    if checkpoint and str(checkpoint).endswith(".npz"):
        return MASt3RModel.from_npz(checkpoint, img_hw, mcfg, device=device)
    if checkpoint:
        return MASt3RModel.from_torch_checkpoint(checkpoint, img_hw, mcfg, device=device)
    print("WARNING: no checkpoint; random weights (geometry will be noise)", file=sys.stderr)
    return MASt3RModel.random_init(seed, img_hw, mcfg, device=device)


def build_slam(cfg, dataset, checkpoint=None, retrieval_checkpoint=None,
               codebook=None, seed=0, preset="vit_large", device=None, model=None):
    """The engine for ``dataset`` under ``cfg``: the model from ``checkpoint``
    (``.npz`` or ``.pth``), random weights from ``seed`` without one, or
    ``model`` itself when given (any object with the model protocol); a
    retrieval database from ``retrieval_checkpoint`` and ``codebook``."""
    from ..device import resolve_device
    from .pipeline import SLAM

    device = resolve_device(device)
    (h, w), _ = dataset.get_img_shape()
    img_hw = (int(h), int(w))
    if model is None:
        model = build_model(cfg, img_hw, checkpoint, seed, preset, device)

    retrieval = None
    if retrieval_checkpoint and codebook:
        from ..retrieval import RetrievalDatabase

        retrieval = RetrievalDatabase.from_torch_checkpoint(
            retrieval_checkpoint, codebook, device=device)

    K = None
    if cfg["use_calib"] and dataset.has_calib():
        K = torch.as_tensor(dataset.camera_intrinsics.K_frame, dtype=torch.float32)
    return SLAM(model, cfg, img_hw, K=K, retrieval=retrieval, device=device)


def parse_overrides(overrides, error):
    """``--set DOTTED.KEY=VALUE`` strings -> nested dicts to merge, each
    value read as a YAML scalar; ``error(msg)`` rejects a malformed one."""
    from ..utils.yaml_subset import parse_scalar

    patches = []
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            error(f"--set expects DOTTED.KEY=VALUE, got {ov!r}")
        if not raw:
            # 'KEY=' would parse to None and silently null the key
            error(f"--set {key}= has an empty value; pass an explicit YAML scalar "
                  f"(use '{key}=null' to null the key)")
        try:
            patch = parse_scalar(raw)
        except ValueError as e:
            error(f"--set {ov!r}: {e}")
        for part in reversed(key.split(".")):
            patch = {part: patch}
        patches.append(patch)
    return patches


def _note_unported(cfg):
    engine = cfg.get("engine", {})
    if "attn_impl" in engine:
        print(f"engine.attn_impl: {engine['attn_impl']!r} selects a JAX attention; "
              "the port runs its own attention kernel (csrc/attention.cu) on the card")
    if engine.get("ln_stats", "twopass") != "twopass":
        print(f"engine.ln_stats: {engine['ln_stats']!r} is a JAX reduction choice; the "
              "port computes layer-norm statistics in two passes")


def main(argv=None):
    parser = argparse.ArgumentParser(description="MASt3R-class SLAM on a CUDA card")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--config", default="base")
    parser.add_argument("--save-as", default="default")
    parser.add_argument("--calib", default="")
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--retrieval-checkpoint", default="")
    parser.add_argument("--codebook", default="")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--no-viz", action="store_true", help="compat no-op")
    parser.add_argument("--model-preset", default="vit_large",
                        choices=["vit_large", "tiny"],
                        help="tiny = smoke-test trunk (random weights)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage timing report at the end")
    parser.add_argument("--viz-ws", type=int, default=0, metavar="PORT",
                        help="stream live pose/keyframe events on ws://127.0.0.1:PORT "
                             "(open mast3r_slam_tpu_torch/viz/viewer.html?ws=...); 0: off")
    parser.add_argument("--trace", default="",
                        help="write a torch.profiler trace (chrome JSON) to this dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default; raises without a card) "
                             "or cpu")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="DOTTED.KEY=VALUE",
                        help="override a config value (repeatable), e.g. "
                             "--set engine.mesh=8 --set tracking.Q_conf=1.5; values parse "
                             "as YAML scalars")
    args = parser.parse_args(argv)

    from ..config import load_config, merge_config
    from ..data.dataloader import Intrinsics, load_dataset
    from ..device import resolve_device
    from ..eval.export import save_keyframes, save_reconstruction
    from ..utils.yaml_subset import load_file as load_yaml
    from ..viz.renderer import export_scene_json, render_topdown

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.calib:
        cfg = merge_config(cfg, {"use_calib": True})
    for patch in parse_overrides(args.overrides, parser.error):
        cfg = merge_config(cfg, patch)
    _note_unported(cfg)

    dataset = load_dataset(args.dataset, use_calib=cfg["use_calib"],
                           center_pp=cfg["dataset"]["center_principle_point"])
    if args.calib:
        # a user intrinsics file: width, height, calibration list
        intr = load_yaml(args.calib)
        dataset.use_calibration = True
        dataset.camera_intrinsics = Intrinsics.from_calib(
            dataset.img_size, intr["width"], intr["height"],
            np.asarray(intr["calibration"], dtype=np.float64),
            center_pp=cfg["dataset"]["center_principle_point"])
    if cfg["use_calib"] and not dataset.has_calib():
        print("[Warning] No calibration provided for this dataset!")
        return None
    if cfg["dataset"]["subsample"] > 1:
        dataset.subsample(cfg["dataset"]["subsample"])
    if dataset.img_size != 512:
        # the engine resizes as the dataset does
        cfg.setdefault("engine", {})["resize"] = dataset.img_size

    slam = build_slam(cfg, dataset, checkpoint=args.checkpoint or None,
                      retrieval_checkpoint=args.retrieval_checkpoint or None,
                      codebook=args.codebook or None, preset=args.model_preset,
                      device=device)
    broadcaster = None
    try:
        if args.viz_ws:
            from ..serve.broadcast import EventBroadcaster

            broadcaster = EventBroadcaster(port=args.viz_ws).start()
            slam.on_event = broadcaster.push
            # the viewer's pause / step / threshold / terminate
            slam.control = broadcaster.control
            print(f"live viewer stream: ws://127.0.0.1:{broadcaster.bound_port} "
                  f"(open mast3r_slam_tpu_torch/viz/viewer.html?ws=...)", flush=True)
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                result = slam.run(dataset, max_frames=args.max_frames)
            trace_dir = pathlib.Path(args.trace)
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_dir / "trace.json"))
        else:
            result = slam.run(dataset, max_frames=args.max_frames)
    finally:
        slam.close()
        if broadcaster is not None:
            broadcaster.stop()

    save_dir = pathlib.Path("logs")
    if args.save_as != "default":
        save_dir = save_dir / args.save_as
    save_dir.mkdir(parents=True, exist_ok=True)
    seq = pathlib.Path(args.dataset).stem

    if dataset.save_results:
        timed = slam.timer.time
        with timed("export.trajectory"):
            slam.save_trajectory(save_dir / f"{seq}.txt", result)
        with timed("export.ply"):
            # the viewer's slider sets the export threshold
            save_reconstruction(save_dir / f"{seq}.ply", slam.keyframes, slam.img_hw,
                                conf_threshold=(slam.control.conf_threshold
                                                if slam.control is not None else 1.5),
                                use_calib=cfg["use_calib"])
        with timed("export.keyframes"):
            save_keyframes(save_dir / "keyframes" / seq, dataset.timestamps,
                           slam.keyframes)
        edges = [(int(slam.graph.ii[e]), int(slam.graph.jj[e]))
                 for e in range(slam.graph.n_edges)]
        with timed("export.map"):
            render_topdown(slam.keyframes, save_dir / f"{seq}_map.png", edges=edges)
        with timed("export.scene"):
            export_scene_json(slam, save_dir / f"{seq}_scene.json")
    if args.profile:
        print(slam.timer.report())
    print(f"done: {result.n_keyframes} keyframes, {result.fps:.2f} fps, "
          f"{result.n_reloc} reloc frames -> {save_dir}/{seq}.txt")
    return result


if __name__ == "__main__":
    main()
