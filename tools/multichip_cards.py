#!/usr/bin/env python3
"""The multi-device path with a card a rank, over NCCL.

Run from the repository root on a machine with several cards:

    python3 tools/multichip_cards.py [--world 4] [--mp 2]

It builds the kernels and runs ``chip_smoke.phase_multichip`` with 10b's
ranks on NCCL, rank r on card r: ``--world`` ranks in a (world / mp) x mp
mesh and a two-level (2, world / (2 mp), mp) one, the sparse path's design
at 1,000,000 rows (``chip_smoke.py`` phase 7), each result held against
one card's within the same bounds as phase 10, and each rank's step time
beside one card's (10a).  ``--device cpu --n 4000`` rehearses it on the
CPU over gloo at 4,000 rows.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--mp", type=int, default=2)
    parser.add_argument("--n", type=int, default=chip_smoke.N)
    parser.add_argument("--device", default=None, help="cpu: a rehearsal over gloo")
    args = parser.parse_args(argv)
    if args.world % (2 * args.mp):
        parser.error("--world must be a multiple of 2 * --mp")
    on_cpu = args.device == "cpu"
    if on_cpu:
        card, backend, levels = "cpu", "gloo", 30
    else:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
            print(f"multichip_cards: needs {args.world} CUDA cards", file=sys.stderr)
            return 1
        card = chip_smoke.phase_environment()
        chip_smoke.phase_build()
        backend, levels = "nccl", chip_smoke.MIX_LEVELS
    n = args.n
    chip_smoke.phase_multichip(
        card, chip_smoke.sparse_block(n), n=n, levels=levels, device=args.device,
        world=args.world, mp=args.mp, two_level=(2, args.world // (2 * args.mp), args.mp),
        sandwich_shape=(n, chip_smoke.K), seg_w=min(chip_smoke.MULTI_SEG_W, n // 4),
        mixed_shape=(n, chip_smoke.MIX_KD, chip_smoke.SP_KS, levels),
        one_rank_backend="gloo" if on_cpu else "nccl", ranks_backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
