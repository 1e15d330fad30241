"""fski config loading: the FitSKIRT front-end.

ref: FitSKIRTmain/FitSkirtCommandLineHandler.cpp (fski batch runs),
FitSKIRTcore/AdjustableSkirtSimulation.cpp:150-193 (ski templates with
`[label:default]` attribute segments and value substitution),
OligoFitScheme.hpp (simulation + parameterRanges + referenceImages +
optim properties), ReferenceImage.hpp, Optimization.hpp:29-52.

Batched re-design: instead of re-running SKIRT in-process per genome with a
serialized master/slave task farm, each genome's forward model is an
OligoSimulation built from the substituted template; per-component frames
come from one run per stellar component (linear superposition makes this
exactly equivalent to the reference's writeStellarComps decomposition),
and the GA + luminosity sub-fit run through fit.scheme.FitScheme.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..log import Log, SilentLog
from .. import rng
from ..ski import (Node, SkiParseError, _parse_element, build_simulation,
                   parse_list, parse_scalar)
from .convolution import FitsKernel, GaussianKernel
from .ranges import ParameterRange
from .reference_image import ReferenceImage
from .scheme import FitScheme


# ---------------------------------------------------------------------------
# ski template label substitution (ref: AdjustableSkirtSimulation.cpp:150-193)
# ---------------------------------------------------------------------------

def _split_segments(text: str):
    """Yield (literal, label, default) triples for each [label:default]."""
    index = 0
    while True:
        left = text.find("[", index)
        if left < 0:
            break
        right = text.find("]", left + 1)
        if right < 0:
            raise SkiParseError("square brackets not balanced in ski template")
        segment = text[left + 1:right]
        if "[" in segment:
            raise SkiParseError("square brackets not balanced in ski template")
        colon = segment.find(":")
        if colon < 0:
            raise SkiParseError("bracket segment lacks a label colon")
        yield text[index:left], segment[:colon], segment[colon + 1:]
        index = right + 1
    yield text[index:], None, None


def template_labels(text: str) -> dict:
    """All labels in a ski template mapped to their default value strings."""
    out = {}
    for _lit, label, default in _split_segments(text):
        if label is not None and label not in out:
            out[label] = default
    return out


def substitute_labels(text: str, values: dict | None = None) -> str:
    """Replace each [label:default] with the value (SI number) or default."""
    values = values or {}
    parts = []
    for lit, label, default in _split_segments(text):
        parts.append(lit)
        if label is None:
            continue
        if label in values:
            parts.append(f"{float(values[label]):.10e}")
        else:
            parts.append(default)
    out = "".join(parts)
    if "]" in out:
        raise SkiParseError("square brackets not balanced in ski template")
    return out


def parse_ski_text(text: str) -> Node:
    root = ET.fromstring(text)
    sims = list(root)
    if len(sims) != 1:
        raise SkiParseError("expected exactly one simulation element")
    return _parse_element(sims[0])


# ---------------------------------------------------------------------------
# fski parsing
# ---------------------------------------------------------------------------

def parse_fski(path: str) -> Node:
    tree = ET.parse(path)
    root = tree.getroot()
    schemes = list(root)
    if len(schemes) != 1:
        raise SkiParseError("expected exactly one fit-scheme element")
    node = _parse_element(schemes[0])
    if node.name != "OligoFitScheme":
        raise SkiParseError(f"unsupported fit scheme '{node.name}'")
    return node


def _build_kernel(img_node: Node):
    # newer format: kernel -> GaussianKernel/FitsKernel; tutorial-era
    # format: convolution -> Convolution fwhm/dimension
    kn = img_node.child("kernel") or img_node.child("convolution")
    if kn is None:
        return GaussianKernel(2.0)
    if kn.name in ("GaussianKernel", "Convolution"):
        return GaussianKernel(kn.scalar("fwhm", 2.0),
                              int(kn.scalar("dimension", 6)))
    if kn.name == "FitsKernel":
        return FitsKernel(kn.attrs["filename"])
    raise SkiParseError(f"unsupported convolution kernel '{kn.name}'")


def _extract_frames(instr, tallies, ell: int) -> np.ndarray:
    """One (ny, nx) frame at wavelength index ell from raw tallies."""
    flat = np.asarray(tallies["ftot"], np.float64)
    if hasattr(instr, "_offsets"):   # MultiFrameInstrument
        off = np.asarray(instr._offsets)
        fr = instr.frames[ell]
        return flat[int(off[ell]):int(off[ell + 1])].reshape(fr.ny, fr.nx)
    npix = instr.nx * instr.ny
    return flat[ell * npix:(ell + 1) * npix].reshape(instr.ny, instr.nx)


def load_fski(path: str, *, out_dir: str = ".", log: Log | None = None,
              packets: float | None = None, batch_size: int = 1 << 14,
              prefix: str | None = None, fast_path: bool = False) -> FitScheme:
    """Build a runnable FitScheme from an fski file.

    ref: FitSkirtCommandLineHandler::doBatch — parse the fit scheme, load
    the labeled ski template it names, and run GA generations.
    """
    log = log or SilentLog()
    fs = parse_fski(path)
    base_dir = os.path.dirname(os.path.abspath(path))

    sim_node = fs.child("simulation")
    if sim_node is None or "skiName" not in sim_node.attrs:
        raise SkiParseError("fski must name an AdjustableSkirtSimulation ski")
    ski_path = sim_node.attrs["skiName"]
    if not os.path.isabs(ski_path):
        ski_path = os.path.join(base_dir, ski_path)
    template = open(ski_path).read()
    labels = template_labels(template)

    # parameter ranges (ref: ParameterRange.hpp — label/type/min/max)
    ranges = []
    pr_node = fs.child("parameterRanges")
    for rn in (pr_node.children.get("ranges", []) if pr_node else []):
        label = rn.attrs["label"]
        if label not in labels:
            raise SkiParseError(f"range label '{label}' not found in the "
                                f"ski template {ski_path}")
        ranges.append(ParameterRange(
            label,
            parse_scalar(rn.attrs["minimumValue"]),
            parse_scalar(rn.attrs["maximumValue"]),
            rn.get("quantityType", "dimless")))
    if not ranges:
        raise SkiParseError("fski defines no parameter ranges")

    # reference images (ref: ReferenceImage.hpp — filename/path + kernel +
    # per-component luminosity bounds)
    images = []
    ri_node = fs.child("referenceImages")
    for im in (ri_node.children.get("images", []) if ri_node else []):
        fname = im.get("filename") or im.get("path")
        if not os.path.isabs(fname):
            fname = os.path.join(base_dir, fname)
        from ..io.fits import read_fits
        data, _hdr = read_fits(fname)
        data = np.asarray(data, np.float64)
        if data.ndim == 3:
            data = data[0]
        images.append(ReferenceImage(
            data, _build_kernel(im),
            parse_list(im.attrs["minLuminosities"]),
            parse_list(im.attrs["maxLuminosities"])))
    if not images:
        raise SkiParseError("fski defines no reference images")

    opt = fs.child("optim") or Node("Optimization", {})
    fixed_seed = fs.boolean("fixedSeed", True)

    def simulate(params: dict):
        """Per-genome forward model: one run per stellar component.

        ref: OligoFitScheme::objective — the reference reads per-component
        frames from one MultiFrameInstrument run (writeStellarComps); the
        per-component runs here produce the identical decomposition by
        linearity of the transfer equation.
        """
        text = substitute_labels(template, params)
        node = parse_ski_text(text)
        sim = build_simulation(node, out_dir=out_dir,
                               prefix="fit_tmp", packets=packets,
                               log=SilentLog(), batch_size=batch_size,
                               seed=4357 if fixed_seed else None,
                               fast_path=fast_path)
        comps = sim.stellar_system.components
        bias = sim.stellar_system.emission_bias
        # frame-capable instrument: the first with a pixel tally
        ins_index = next(
            (i for i, ins in enumerate(sim.instruments)
             if "ftot" in ins.zero_tallies()), None)
        if ins_index is None:
            raise SkiParseError("the ski template needs a frame instrument")
        if sim.nlambda < len(images):
            raise SkiParseError(
                f"{len(images)} reference images need at least as many "
                f"wavelengths in the ski template ({sim.nlambda} found)")

        from ..sources.stellar import StellarSystem
        from ..engine.simulation import OligoSimulation
        per_comp_tallies = []
        for ci, comp in enumerate(comps):
            sub = OligoSimulation(
                stellar_system=StellarSystem([comp], emission_bias=bias),
                instruments=sim.instruments,
                dust_system=sim.dust_system,
                packets=sim.packets, seed=sim.seed,
                options=sim.options, log=SilentLog(),
                batch_size=batch_size, out_dir=out_dir, prefix="fit_tmp")
            acc = sub._run_phase(rng.root_key(sim.seed + ci), 0)
            per_comp_tallies.append(acc["instruments"][ins_index])

        instr = sim.instruments[ins_index]
        return [[_extract_frames(instr, t, j) for t in per_comp_tallies]
                for j in range(len(images))]

    return FitScheme(
        ranges=ranges, reference_images=images, simulate=simulate,
        generations=int(opt.scalar("generations", 100)),
        popsize=int(opt.scalar("popsize", 100)),
        pmut=opt.scalar("pmut", 0.03), pcross=opt.scalar("pcross", 0.65),
        fixed_seed=fixed_seed, log=log, out_dir=out_dir,
        prefix=prefix or os.path.splitext(os.path.basename(path))[0])
