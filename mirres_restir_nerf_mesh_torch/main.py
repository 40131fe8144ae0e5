"""The command line (counterpart of the root main.py), flag for flag:

    python3 -m mirres_restir_nerf_mesh_torch.main <scene> --workspace ws --stage 0 -O
    python3 -m mirres_restir_nerf_mesh_torch.main <scene> --workspace ws --stage 1 --use_brdf --use_restir
    python3 -m mirres_restir_nerf_mesh_torch.main <scene> --workspace ws --stage 1 --test [--envmap_path x.hdr]

The argparse surface is generated from the Config dataclass, so every flag
keeps its name and default.  ``--data_format`` picks the loader: ``nerf``
(blender-format ``transforms*.json``), ``colmap`` (a COLMAP workspace, as
``configs/general_config_for_your_dataset.txt`` runs it) or ``dtu``.  It
runs on the card; ``main(argv, device="cpu")`` runs on the CPU.

Data parallelism (``--data_parallel``, on by default, as in the JAX
package): with more than one card visible, ``main`` spawns one NCCL rank
a card (``parallel.mesh.launch``); under ``torchrun`` it joins the group
torchrun describes (NCCL on the card, gloo with ``device="cpu"``):

    torchrun --nproc_per_node 4 -m mirres_restir_nerf_mesh_torch.main <scene> --workspace ws -O

A rank that fails makes the run fail; a failed process-group init raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from .config import Config, finalize


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    for f in dataclasses.fields(Config):
        if f.name == "path":
            continue
        name = f.name
        default = f.default
        if f.type in ("bool", bool) or isinstance(default, bool):
            if name == "O":
                parser.add_argument("-O", action="store_true")
            else:
                parser.add_argument(f"--{name}", action="store_true", default=default)
        elif isinstance(default, tuple):
            elem = float if (default and isinstance(default[0], float)) else int
            parser.add_argument(f"--{name}", type=elem, nargs="*", default=list(default))
        elif isinstance(default, int):
            parser.add_argument(f"--{name}", type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(f"--{name}", type=float, default=default)
        else:
            parser.add_argument(f"--{name}", type=str, default=default)
    return parser


def config_from_args(argv=None) -> Config:
    args = build_parser().parse_args(argv)
    kwargs = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, f.default)
        if isinstance(f.default, tuple) and isinstance(v, list):
            v = tuple(v)
        if f.name == "scene_aabb" and isinstance(v, str):
            # comma-separated floats (argparse can't take negative nargs)
            v = None if v in ("None", "") else tuple(float(x) for x in v.split(","))
        kwargs[f.name] = v
    return finalize(Config(**kwargs))


def load_dataset(cfg: Config, split: str):
    if cfg.data_format == "colmap":
        from .data.colmap import load_colmap

        return load_colmap(cfg.path, split=split, downscale=cfg.downscale, scale=cfg.scale,
                           offset=cfg.offset, bound=cfg.bound,
                           enable_cam_center=cfg.enable_cam_center)
    if cfg.data_format == "dtu":
        from .data.dtu import load_dtu

        return load_dtu(cfg.path, split=split, downscale=cfg.downscale, bound=cfg.bound)
    from .data.provider import load_blender

    scale = cfg.scale if cfg.scale > 0 else 0.8
    return load_blender(cfg.path, split=split, downscale=cfg.downscale, scale=scale,
                        offset=cfg.offset, bound=cfg.bound)


def main(argv=None, device="cuda") -> None:
    import torch

    from .device import resolve_device
    from .parallel import mesh as pmesh

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(argv)
    if cfg.data_parallel and "WORLD_SIZE" in os.environ:
        # under torchrun: join its group
        dp = pmesh.init_data_parallel(device)
        try:
            run(cfg, dp.device, dp)
        finally:
            torch.distributed.destroy_process_group()
    elif (cfg.data_parallel and resolve_device(device).type == "cuda"
          and torch.cuda.device_count() > 1):
        pmesh.launch(_rank_main, torch.cuda.device_count(), backend="nccl", args=(argv,))
    else:
        run(cfg, device)


def _rank_main(dp, argv) -> None:
    run(config_from_args(argv), dp.device, dp)


def run(cfg: Config, device="cuda", dp=None) -> None:
    """Train, test or export as ``cfg`` says (one rank's part under ``dp``)."""
    from .train.trainer import Trainer

    split = cfg.train_split if not cfg.test else "test"
    data = load_dataset(cfg, split)
    trainer = Trainer("ngp", cfg, data, workspace=cfg.workspace, device=device, dp=dp)

    if cfg.test:
        try:
            val = load_dataset(cfg, "test")
            trainer.evaluate(val)
        except Exception as e:
            print(f"[warn] eval skipped: {e}")
        trainer.test(data)
        if cfg.stage == 1 and not cfg.test_no_mesh:
            trainer.export_stage1()
        return

    # val split for in-training eval and best-checkpoint selection
    try:
        val = load_dataset(cfg, "val")
    except Exception as e:
        print(f"[warn] no val split: {e}")
        val = None

    trainer.train(valid_data=val)
    if val is not None:
        trainer.evaluate(val)

    if cfg.stage == 0 and not cfg.test_no_mesh:
        trainer.save_mesh()
    elif cfg.stage == 1:
        trainer.export_stage1()


if __name__ == "__main__":
    main()
