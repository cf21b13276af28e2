"""The readings that set the SwinIR cell's limits (not run by the
benchmark's own runs): those of benchmark/controls_rrdb.py (for each seed,
at the cell's own size, in one process, a short window of `--frames`
frames of the cell's chain, and "program", the program's frames against
the reference; "control", the float8 (e4m3) reference; "altered", a
64 x 64 block of each output set to 0 where it is produced), with the
program imported from `--program DIR` where given: a scratch copy of
srgan_st_tpu_torch (DIR/srgan_st_tpu_torch) holding a planted fault, whose
frames read as "program" against this checkout's reference and seeded
weights. The fault's kernels build in DIR/build.

    python3 benchmark/controls_swinir.py --workload swinir_m_realsr_x4.video_4k_swinir \\
        --seeds 1,2,3 [--what W,...] [--frames 8] [--program DIR]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from benchmark import controls_rrdb  # (it puts this checkout first on the path)

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--program", default=None)
    args, rest = p.parse_known_args(argv)
    if args.program:
        # before anything imports the program: the copy's package is found first
        sys.path.insert(0, os.path.abspath(args.program))
    import srgan_st_tpu_torch

    print(json.dumps({"program": os.path.dirname(srgan_st_tpu_torch.__file__)}), flush=True)
    return controls_rrdb.main(rest)


if __name__ == "__main__":
    sys.exit(main())
