"""Tile size and design of the Gram kernels: device time on one card.

Builds the kernels' library twice through ``kernels.build_library(tile)``,
with forward output tiles of 32x32 and of 64x64 (the shipped size), and
times the forward of each build at the main path's shapes: device time from
chip_smoke.py's CUDA graph of back-to-back launches, builds in turns (64,
32, 32, 64) within one process. Each build's forward must equal the first's
bit for bit.

With ``--backward`` it times the hyperparameter backward instead, whose
one library holds both tile edges (``kernels.launch_backward(tile=...)``),
at chip smoke's phase-3 shapes, in the same turns, beside the edge that
``kernels.backward_tile`` picks; each edge's gradients must agree with the
other's to 1e-10 of the largest component of each.

With ``--backward-x`` it times the coordinate backward
(``kernels.launch_backward(..., grad_x=..., tile=...)``) at the input
warp's shapes with per-lane x, in the same turns, beside the edge that
``kernels.backward_tile`` picks; each edge's dL/dx must agree with the
other's to 1e-10 of the largest component.

    python tools/torch_port_tile_sweep.py [--backward | --backward-x]
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TILES = (64, 32, 32, 64)
SHAPES = ((128, 2), (128, 8), (1024, 8), (1280, 8), (2048, 8), (1280, 30))
# (cap, d) of the hyperparameter backward: chip_smoke.py phase 3's, with 1
# and 4 lanes
SHAPES_BWD = ((128, 8), (1024, 8), (1280, 8), (2048, 8), (1280, 30))


# (cap, d, lanes) of the coordinate backward: the warp fit's shape, cap 384,
# the warp at d=30, and caps past the 32/64 switch at 8 lanes
SHAPES_X = ((256, 6, 8), (384, 6, 8), (1280, 30, 4), (448, 6, 8),
            (512, 6, 8), (1024, 6, 8), (1280, 6, 8), (2048, 30, 4))


def sweep_backward(cs, kr, need_x):
    """Each tile edge's device time in turns at the hyperparameter
    backward's shapes, or with ``need_x`` the coordinate backward's."""
    dev = torch.device("cuda")
    shapes = SHAPES_X if need_x else [(cap, d, lanes) for cap, d in SHAPES_BWD
                                      for lanes in (1, 4)]
    for cap, d, lanes in shapes:
        x, mask, ls, amp, _, _ = cs._inputs(cap, d, cap + lanes,
                                            torch.float64, dev, lanes, need_x)
        g = torch.as_tensor(np.random.default_rng(cap).normal(
            size=(lanes, cap, cap)), device=dev)
        new = lambda n: torch.empty(n, dtype=torch.float64, device=dev)
        ref, row = None, []
        for tile in TILES:
            n_part, n_dx, _ = kr.backward_scratch_sizes(cap, d, lanes, tile,
                                                        need_x)
            part = new(n_part)
            out = [new((lanes, d)), new(lanes)]
            extra = {}
            if need_x:
                out.append(new((lanes, cap, d)))
                extra = {"dxpart": new(n_dx), "grad_x": out[2]}
            t = cs._device_ms(lambda: kr.launch_backward(
                "rbf", x, mask, ls, amp, g, part, out[0], out[1], tile=tile,
                **extra))
            if ref is None:
                ref = [o.clone() for o in out]
            for got, want in zip(out, ref):
                if float((got - want).abs().max() / want.abs().max()) > 1e-10:
                    raise AssertionError(f"tile {tile} cap={cap} d={d}: "
                                         "gradients differ")
            row.append(f"t{tile} {t * 1e3:.2f} us")
        print(f"backward{'_x' if need_x else ''} cap={cap} d={d} "
              f"lanes={lanes} (picks {kr.backward_tile(cap, d, lanes)}): "
              + " | ".join(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("torch_port_tile_sweep: no CUDA device visible",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bobe_tpu_torch.ops import kernels as kr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if sys.argv[1:] in (["--backward-x"], ["--backward"]):
        kr.build_library()
        for ln in kr.build_info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "bwd" in ln:
                print(f"ptxas: {ln.strip()}")
        sweep_backward(cs, kr, need_x=sys.argv[1] == "--backward-x")
        return 0
    for tile in sorted(set(TILES)):
        kr.build_library(tile)
        regs = [ln.split(":", 1)[1].strip()
                for ln in kr.build_info["log"].splitlines()
                if "registers" in ln]
        print(f"tile {tile}: ptxas {regs}")
    dev = torch.device("cuda")
    for cap, d in SHAPES:
        for lanes in (1, 4):
            x, mask, ls, amp, noise, _ = cs._inputs(
                cap, d, cap + lanes, torch.float64, dev, lanes)
            ref, row = None, []
            for tile in TILES:
                k_out = torch.empty((lanes, cap, cap), dtype=torch.float64,
                                    device=dev)
                t_f = cs._device_ms(lambda: kr.launch_forward(
                    "rbf", x, mask, ls, amp, noise, k_out, tile))
                if ref is None:
                    ref = k_out.clone()
                elif not torch.equal(k_out, ref):
                    raise AssertionError(f"tile {tile} cap={cap} d={d}: "
                                         "results differ")
                row.append(f"t{tile} fwd {t_f * 1e3:.2f} us")
            print(f"cap={cap} d={d} lanes={lanes}: " + " | ".join(row),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
