"""Wizard-style guided creation/editing of ski and fski files (console).

ref: SkirtMakeUp/WizardEngine.hpp:19-57 — a state machine over the
Discover layer: a basic-choice state ("what would you like to do"),
per-property panes, advance/retreat navigation, dirty tracking and
open/save of ski/fski hierarchies.  The Qt widget panes map here to
console panes; the state machine semantics (canAdvance/canRetreat/
advance/retreat/isDirty/filepath) are preserved.

Design: the engine replays a recorded answer log through a
pure construction program to find the current pane — retreat is simply
popping the last answer, so navigation can never desynchronize from the
tree under construction.  Injectable streams make it scriptable and
testable (same contract as console.ConsoleCreator).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from .discover import SUPPORTED, write_ski
from .ski import Node, parse_ski


@dataclass
class Pane:
    """One wizard question (ref: WizardEngine per-property panes)."""
    prompt: str
    options: list[str] | None = None    # None = free-entry pane
    default: str | None = None
    key: str = ""                       # stable id for tests/debugging


class _NeedInput(Exception):
    """Replay ran out of recorded answers; carries the pane to show."""

    def __init__(self, pane: Pane):
        self.pane = pane


class _Done(Exception):
    """The program completed; carries the final (root, path) result."""

    def __init__(self, root: Node, path: str):
        self.root = root
        self.path = path


class _Feed:
    """Answer-log replayer handed to the construction program."""

    def __init__(self, answers: list[str]):
        self.answers = list(answers)
        self.pos = 0

    def ask(self, prompt: str, default: str | None = None,
            key: str = "") -> str:
        if self.pos >= len(self.answers):
            raise _NeedInput(Pane(prompt, None, default, key or prompt))
        v = self.answers[self.pos]
        self.pos += 1
        return v if v else (default or "")

    def choose(self, prompt: str, options: list[str],
               default: str | None = None, key: str = "") -> str:
        default = default if default in options else options[0]
        if self.pos >= len(self.answers):
            raise _NeedInput(Pane(prompt, list(options), default,
                                  key or prompt))
        v = self.answers[self.pos]
        self.pos += 1
        if not v:
            return default
        if v in options:
            return v
        try:
            k = int(v)
            if 1 <= k <= len(options):
                return options[k - 1]
        except ValueError:
            pass
        return default

    def yesno(self, prompt: str, default: bool, key: str = "") -> bool:
        v = self.ask(f"{prompt} (yes/no)", "yes" if default else "no", key)
        return v.strip().lower().startswith("y")


def _of_kind(kind: str) -> list[str]:
    return sorted(n for n, m in SUPPORTED.items() if m.get("kind") == kind)


def _child_kind(cls: str, child_prop: str) -> str:
    mapping = {
        "geometry": "geometry", "firstGeometry": "geometry",
        "secondGeometry": "geometry", "sed": "sed",
        "normalization": "stellarNormalization",
        "meshX": "mesh", "meshY": "mesh", "meshZ": "mesh", "meshR": "mesh",
        "mix": "dustMix", "dustMix": "dustMix",
        "kernel": "smoothingKernel", "sedFamily": "sedFamily",
        "dustEmissivity": "dustEmissivity", "dustLib": "dustLib",
        "dustGrid": "dustGrid", "wavelengthGrid": "wavelengthGrid",
    }
    if child_prop in mapping:
        return mapping[child_prop]
    # many child properties are literally named after their kind
    # (adaptiveMeshFile, voronoiMeshFile, dustDistribution, ...)
    if any(m.get("kind") == child_prop for m in SUPPORTED.values()):
        return child_prop
    if child_prop.endswith("Geometry") or child_prop.endswith("geometry"):
        return "geometry"
    return child_prop


class WizardEngine:
    """Console wizard state machine (ref: SkirtMakeUp/WizardEngine).

    Use `current_pane()` to get the active question, `advance(value)` /
    `retreat()` to navigate, and `run()` for an interactive console
    session.  `is_dirty()`/`filepath()` mirror the reference's unsaved
    -state tracking.
    """

    def __init__(self):
        self.answers: list[str] = []
        self._saved_at_len: int | None = None  # answer-log length when saved
        self._result: tuple[Node, str] | None = None

    # -- state handling (ref: WizardEngine.hpp:36-58) ----------------------

    def can_advance(self) -> bool:
        return self._result is None

    def can_retreat(self) -> bool:
        return len(self.answers) > 0

    def is_dirty(self) -> bool:
        return (len(self.answers) > 0
                and self._saved_at_len != len(self.answers))

    def filepath(self) -> str:
        return self._result[1] if self._result else ""

    def root(self) -> Node | None:
        return self._result[0] if self._result else None

    def current_pane(self) -> Pane | None:
        """Replay the answer log; None once the program completed."""
        feed = _Feed(self.answers)
        try:
            self._program(feed)
        except _NeedInput as need:
            return need.pane
        except _Done:
            return None
        return None

    def advance(self, value: str = ""):
        if not self.can_advance():
            raise RuntimeError("the wizard has completed")
        self.answers.append(value)
        feed = _Feed(self.answers)
        try:
            self._program(feed)
        except _NeedInput:
            pass
        except _Done as done:
            self._result = (done.root, done.path)
        except Exception as e:
            # a bad answer (unreadable ski path, malformed file): undo it
            # so the pane re-asks instead of wedging the state machine
            self.answers.pop()
            raise ValueError(str(e)) from e

    def retreat(self):
        if not self.can_retreat():
            raise RuntimeError("already at the first pane")
        self._result = None
        self.answers.pop()

    # -- the construction program ------------------------------------------

    def _program(self, feed: _Feed):
        mode = feed.choose(
            "What would you like to do?",
            ["create a new ski file", "create a new fski file",
             "open and edit an existing ski file"], key="basic-choice")
        if mode.startswith("open"):
            path = feed.ask("path of the ski file to open", key="open-path")
            root = parse_ski(path)
            self._edit_node(feed, root, path=root.name)
            out = feed.ask("save as", path, key="save-path")
            raise _Done(root, out)
        if "fski" in mode:
            root = self._new_fski(feed)
            out = feed.ask("save as", "new.fski", key="save-path")
            raise _Done(root, out)
        root = self._new_ski(feed)
        out = feed.ask("save as", "new.ski", key="save-path")
        raise _Done(root, out)

    # .. new ski (same component walk as console.ConsoleCreator) ...........

    def _build_component(self, feed: _Feed, cls: str) -> Node:
        meta = SUPPORTED.get(cls, {})
        attrs = {}
        for prop in meta.get("properties", []):
            val = feed.ask(f"{cls}.{prop}", "", key=f"{cls}.{prop}")
            if val:
                attrs[prop] = val
        node = Node(cls, attrs)
        for child_prop in meta.get("children", []):
            options = _of_kind(_child_kind(cls, child_prop))
            if not options:
                continue
            chosen = feed.choose(f"select the {child_prop} for {cls}",
                                 options, key=f"{cls}.{child_prop}")
            node.children[child_prop] = [self._build_component(feed, chosen)]
        return node

    def _new_ski(self, feed: _Feed) -> Node:
        sim_cls = feed.choose(
            "what kind of simulation?",
            ["OligoMonteCarloSimulation", "PanMonteCarloSimulation"],
            key="sim-type")
        sim = Node(sim_cls, {"packages": feed.ask(
            "number of photon packages", "1e6", key="packages")})
        units = feed.choose(
            "units system",
            ["ExtragalacticUnits", "StellarUnits", "SIUnits"], key="units")
        sim.children["units"] = [Node(units, {})]
        wg = feed.choose("wavelength grid", _of_kind("wavelengthGrid"),
                         key="wavelengthGrid")
        sim.children["wavelengthGrid"] = [self._build_component(feed, wg)]

        comp_cls = ("OligoStellarComp" if sim_cls.startswith("Oligo")
                    else "PanStellarComp")
        ss = Node("StellarSystem", {})
        ss.children["components"] = [self._build_component(feed, comp_cls)]
        sim.children["stellarSystem"] = [ss]

        if feed.yesno("include a dust system?", True, key="want-dust"):
            ds_cls = ("OligoDustSystem" if sim_cls.startswith("Oligo")
                      else "PanDustSystem")
            ds = Node(ds_cls, {})
            comp = Node("DustComp", {})
            geo = feed.choose("dust geometry", _of_kind("geometry"),
                              key="dust-geometry")
            comp.children["geometry"] = [self._build_component(feed, geo)]
            mix = feed.choose("dust mix", _of_kind("dustMix"),
                              key="dust-mix")
            comp.children["mix"] = [self._build_component(feed, mix)]
            norm = feed.choose("dust normalization",
                               _of_kind("dustNormalization"),
                               key="dust-normalization")
            comp.children["normalization"] = [
                self._build_component(feed, norm)]
            dist = Node("CompDustDistribution", {})
            dist.children["components"] = [comp]
            ds.children["dustDistribution"] = [dist]
            grid = feed.choose("dust grid", _of_kind("dustGrid"),
                               key="dust-grid")
            ds.children["dustGrid"] = [self._build_component(feed, grid)]
            sim.children["dustSystem"] = [ds]

        ins_sys = Node("InstrumentSystem", {})
        instruments = []
        while True:
            ins = feed.choose("add an instrument", _of_kind("instrument"),
                              key="instrument")
            instruments.append(self._build_component(feed, ins))
            if not feed.yesno("add another instrument?", False,
                              key="more-instruments"):
                break
        ins_sys.children["instruments"] = instruments
        sim.children["instrumentSystem"] = [ins_sys]
        return sim

    # .. new fski (ref: FitSKIRT fski hierarchy; fit/fski.py parser) .......

    def _new_fski(self, feed: _Feed) -> Node:
        scheme = Node("OligoFitScheme", {"fixedSeed": "true"})
        scheme.children["units"] = [Node("SIUnits", {})]
        ski = feed.ask("adjustable ski template (skiName)", "template.ski",
                       key="fski-ski")
        adj = Node("AdjustableSkirtSimulation", {"skiName": ski})
        scheme.children["simulation"] = [adj]

        ranges = Node("ParameterRanges", {})
        rlist = []
        while True:
            label = feed.ask("parameter label (as [label:default] in the "
                             "ski template)", "p1", key="range-label")
            qtype = feed.choose("quantity type",
                                ["length", "dimless", "mass", "posangle"],
                                key="range-type")
            lo = feed.ask(f"minimum value for {label}", "0", key="range-min")
            hi = feed.ask(f"maximum value for {label}", "1", key="range-max")
            rlist.append(Node("ParameterRange",
                              {"label": label, "quantityType": qtype,
                               "minimumValue": lo, "maximumValue": hi}))
            if not feed.yesno("add another parameter range?", False,
                              key="more-ranges"):
                break
        ranges.children["ranges"] = rlist
        scheme.children["parameterRanges"] = [ranges]

        images = Node("ReferenceImages", {})
        ilist = []
        while True:
            path = feed.ask("reference image (FITS path)", "ref.fits",
                            key="image-path")
            fwhm = feed.ask("convolution FWHM [pixels]", "2.0",
                            key="image-fwhm")
            lmin = feed.ask("minimum luminosities", "0.1", key="image-lmin")
            lmax = feed.ask("maximum luminosities", "100", key="image-lmax")
            img = Node("ReferenceImage",
                       {"path": path, "minLuminosities": lmin,
                        "maxLuminosities": lmax})
            img.children["convolution"] = [
                Node("Convolution", {"fwhm": fwhm, "dimension": "6"})]
            ilist.append(img)
            if not feed.yesno("add another reference image?", False,
                              key="more-images"):
                break
        images.children["images"] = ilist
        scheme.children["referenceImages"] = [images]

        optim = Node("Optimization", {
            "popsize": feed.ask("GA population size", "20", key="popsize"),
            "generations": feed.ask("GA generations", "10",
                                    key="generations"),
            "pmut": feed.ask("mutation probability", "0.03", key="pmut"),
            "pcross": feed.ask("crossover probability", "0.65",
                               key="pcross")})
        scheme.children["optim"] = [optim]
        return scheme

    # .. edit an existing hierarchy (every property, defaults = current) ...

    def _edit_node(self, feed: _Feed, node: Node, path: str = ""):
        tag = f"{path or node.name}"
        for prop in sorted(node.attrs):
            cur = node.attrs[prop]
            val = feed.ask(f"{tag}.{prop}", cur, key=f"{tag}.{prop}")
            node.attrs[prop] = val
        for child_prop, children in node.children.items():
            for i, child in enumerate(children):
                sfx = f"[{i}]" if len(children) > 1 else ""
                self._edit_node(feed, child,
                                path=f"{tag}.{child_prop}{sfx}"
                                     f".{child.name}")

    # -- interactive console loop ------------------------------------------

    def run(self, stdin=None, stdout=None) -> tuple[Node, str]:
        """Drive the wizard on console streams; '<' retreats one pane.

        Writes the finished hierarchy with discover.write_ski (ski) or
        wizard.write_fski (fski) and returns (root, path).
        """
        fin = stdin or sys.stdin
        fout = stdout or sys.stdout
        while self._result is None:
            pane = self.current_pane()
            if pane is None:                     # defensive; cannot happen
                break
            if pane.options:
                fout.write(pane.prompt + "\n")
                for i, opt in enumerate(pane.options, 1):
                    mark = "*" if opt == pane.default else " "
                    fout.write(f" {mark}{i}. {opt}\n")
                fout.write("enter a number ('<' to go back): ")
            else:
                sfx = f" [{pane.default}]" if pane.default else ""
                fout.write(f"{pane.prompt}{sfx} ('<' to go back): ")
            fout.flush()
            line = fin.readline()
            if not line:
                raise EOFError("input stream closed")
            line = line.strip()
            if line == "<":
                if self.can_retreat():
                    self.retreat()
                else:
                    fout.write("already at the first pane\n")
                continue
            try:
                self.advance(line)
            except ValueError as e:
                fout.write(f"error: {e}\n")
        root, path = self._result
        if path.endswith(".fski") or root.name.endswith("FitScheme"):
            write_fski(root, path)
        else:
            write_ski(root, path)
        self._saved_at_len = len(self.answers)
        fout.write(f"Successfully saved '{path}'.\n")
        return root, path


def write_fski(node: Node, path: str) -> None:
    """Serialize a fit-scheme Node to an fski file (round-trips
    fit.fski.parse_fski)."""
    import xml.etree.ElementTree as ET

    from .discover import node_to_element

    root = ET.Element("skirt-fit-scheme-hierarchy",
                      {"type": "FitScheme", "format": "6.1"})
    root.append(node_to_element(node))
    tree = ET.ElementTree(root)
    ET.indent(tree)
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write(b"<!--FitSKIRT fit scheme-->\n")
        tree.write(f, encoding="utf-8", xml_declaration=False)
