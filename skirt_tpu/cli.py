"""Command-line interface.

ref: SKIRTmain/SkirtCommandLineHandler.cpp:41,368-392 — `skirt [-s N]
[-e] [-o dir] [-i dir] *.ski`.  Thread/process flags of the reference are
replaced by the device mesh (all local accelerator devices are used
automatically); `-e` emulates: forces one packet per wavelength to
exercise setup/teardown (ref :271-284).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="skirt-tpu",
        description="Batched Monte Carlo dust radiative transfer in JAX")
    parser.add_argument("ski", nargs="*",
                        help="ski file(s) or patterns to simulate")
    parser.add_argument("-o", "--output", default=".",
                        help="output directory")
    parser.add_argument("-i", "--input", default=".",
                        help="input directory for data files")
    parser.add_argument("-s", "--seed", type=int, default=None,
                        help="override the random seed")
    parser.add_argument("-p", "--packets", type=float, default=None,
                        help="override the photon package count")
    parser.add_argument("-e", "--emulate", action="store_true",
                        help="emulation mode: 1 packet, no self-absorption")
    parser.add_argument("-b", "--brief", action="store_true",
                        help="brief console logging")
    parser.add_argument("-m", "--memory", action="store_true",
                        help="report memory usage with every log message")
    parser.add_argument("-l", "--log-allocations", type=float, default=None,
                        metavar="GB",
                        help="log device/host memory growth above this "
                             "many GB between phases (the reference's "
                             "per-Array allocation logging analog)")
    parser.add_argument("--fast", action="store_true",
                        help="fast estimators where the model "
                             "allows: analytic midpoint densities + sampled "
                             "absorption deposition (default: reference-"
                             "exact gridded/path estimators)")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend")
    parser.add_argument("--mesh", choices=["auto", "off", "packets", "slab"],
                        default="auto",
                        help="multi-device strategy: 'packets' shards the "
                             "packet axis (replicated tables, the "
                             "reference's MPI model), 'slab' domain-"
                             "decomposes density/tally tables by x-slab, "
                             "'off' forces single-device, 'auto' (default) "
                             "= packets when >1 device")
    parser.add_argument("-x", "--export-schema", action="store_true",
                        help="export the component schema and exit")
    parser.add_argument("-r", "--report", action="store_true",
                        help="also write a LaTeX parameter report")
    args = parser.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    # multi-host: initialize jax.distributed when the standard env vars
    # describe a multi-process run; silently a no-op otherwise (ref: the
    # no-MPI ProcessManager build, MPIsupport/ProcessManager.cpp:21-188)
    from .parallel import initialize_distributed
    initialize_distributed()

    if args.export_schema:
        from .discover import write_schema
        out = os.path.join(args.output, "skirt_tpu_schema.xml")
        os.makedirs(args.output, exist_ok=True)
        write_schema(out)
        print(f"Exported component schema to {out}")
        return 0

    if not args.ski:
        # interactive construction (ref: SkirtCommandLineHandler doInteractive;
        # the wizard adds SkirtMakeUp-style retreat/open/fski, wizard.py)
        if sys.stdin.isatty():
            from .wizard import WizardEngine
            os.makedirs(args.output, exist_ok=True)
            cwd = os.getcwd()
            try:
                os.chdir(args.output)
                WizardEngine().run()
            finally:
                os.chdir(cwd)
            return 0
        print("error: no ski files given (use -x to export the schema, or "
              "run interactively from a terminal)", file=sys.stderr)
        return 2

    from .log import Log
    from .ski import load_ski

    paths = []
    for pattern in args.ski:
        expanded = sorted(glob.glob(pattern))
        if not expanded and os.path.exists(pattern):
            expanded = [pattern]
        if not expanded and os.path.exists(pattern + ".ski"):
            expanded = [pattern + ".ski"]
        if not expanded:
            print(f"error: no ski file matches '{pattern}'", file=sys.stderr)
            return 2
        paths.extend(expanded)

    from .errors import install_signal_handlers
    install_signal_handlers()

    log = Log(lowest="warning" if args.brief else "info",
              with_memory=args.memory)
    if args.log_allocations is not None:
        from .diagnostics import AllocationLogger
        AllocationLogger.install(log, args.log_allocations)
    failed = 0
    for path in paths:
        prefix = os.path.splitext(os.path.basename(path))[0]
        log.info(f"Constructing a simulation from ski file '{path}'...")
        packets = 1.0 if args.emulate else args.packets
        try:
            if path.endswith(".fski"):
                # ref: FitSkirtMain.cpp / FitSkirtCommandLineHandler —
                # fski batch runs drive the GA fit scheme
                from .fit.fski import load_fski
                scheme = load_fski(path, out_dir=args.output, log=log,
                                   packets=packets, fast_path=args.fast)
                with log.timer(f"fit scheme {prefix}"):
                    best, chi2 = scheme.run()
                log.success(f"best chi2 {chi2:.6g} at {best}")
                continue
            if args.report:
                from .discover import latex_report
                from .ski import parse_ski
                os.makedirs(args.output, exist_ok=True)
                latex_report(parse_ski(path),
                             os.path.join(args.output,
                                          f"{prefix}_parameters.tex"))
            mesh_arg = {"auto": None, "off": False, "packets": True,
                        "slab": "slab"}[args.mesh]
            sim = load_ski(path, out_dir=args.output, prefix=prefix,
                           packets=packets, seed=args.seed, log=log,
                           fast_path=args.fast, use_mesh=mesh_arg)
            if args.emulate and hasattr(sim, "self_absorption"):
                sim.self_absorption = False
            with log.timer(f"simulation {prefix}"):
                sim.run()
        except KeyboardInterrupt:
            log.error("interrupted")
            return 130
        except Exception as e:
            # ref: SkirtCommandLineHandler.cpp:359-363 — exceptions are
            # logged before propagating; with multiple ski files the batch
            # continues (deviation: the reference aborts the batch)
            log.error(f"simulation '{prefix}' failed: {e}")
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
