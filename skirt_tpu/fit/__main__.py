"""fitskirt command-line front end: `python -m skirt_tpu.fit model.fski`.

ref: FitSKIRTmain/FitSkirtCommandLineHandler.cpp:109 — batch runs of one
or more fski files with -o/-i/-s flags (interactive creation is the
wizard's fski mode: `python -m skirt_tpu.cli` with no arguments).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="fitskirt", description="run FitSKIRT fski fit schemes")
    parser.add_argument("fski", nargs="*",
                        help="fski file(s), glob patterns allowed; with no "
                             "arguments on a terminal, the interactive "
                             "fski wizard starts")
    parser.add_argument("-o", "--output", default=".",
                        help="output directory")
    parser.add_argument("-i", "--input", default=".",
                        help="input directory (relative reference images)")
    parser.add_argument("-s", "--seed", type=int, default=None,
                        help="override the GA random seed")
    parser.add_argument("-p", "--packets", type=float, default=None,
                        help="override packets per forward simulation")
    parser.add_argument("--fast", action="store_true",
                        help="fast estimators for the per-genome "
                             "forward runs")
    args = parser.parse_args(argv)

    from ..log import Log
    from .fski import load_fski

    if not args.fski:
        # ref: FitSkirtCommandLineHandler doInteractive — guided creation
        if sys.stdin.isatty():
            from ..wizard import WizardEngine
            os.makedirs(args.output, exist_ok=True)
            cwd = os.getcwd()
            try:
                os.chdir(args.output)
                w = WizardEngine()
                w.advance("create a new fski file")
                w.run()
            finally:
                os.chdir(cwd)
            return 0
        print("error: no fski files given (run interactively from a "
              "terminal to create one)", file=sys.stderr)
        return 2

    paths = []
    for pattern in args.fski:
        hits = sorted(glob.glob(pattern))
        if not hits:
            print(f"error: no fski file matches '{pattern}'",
                  file=sys.stderr)
            return 2
        paths.extend(hits)

    os.makedirs(args.output, exist_ok=True)
    for path in paths:
        log = Log()
        log.info(f"Loading fit scheme {path}")
        scheme = load_fski(path, out_dir=args.output, log=log,
                           packets=args.packets, fast_path=args.fast)
        if args.seed is not None:
            # ref: Optimization fixed-seed option (Optimization.cpp:156-163)
            import numpy as _np
            scheme.ga.rng = _np.random.default_rng(args.seed)
        scheme.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
