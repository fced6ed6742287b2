"""Portable command catalog + handlers — the shared UI-glue layer.

Rebuild of ``FractalSharkLib/CommandCatalog.h`` /
``PortableCommandHandlers.*``: a strongly-typed command enum whose
numeric ids mirror the reference's IDM_* values 1:1 (40000-range), a
hotkey table that front-ends (CLI REPL, future GUIs) walk for dispatch
and help listings, and a handler object that applies each command to a
Fractal engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Callable


class FractalCommand(IntEnum):
    NONE = 0
    # ---- general / help ----
    SHOW_HOTKEYS = 40000
    VIEWS_HELP = 40001
    HELP_ALG = 40002
    SQUARE_VIEW = 40010
    CUR_POS = 40015
    EXIT = 40020
    # ---- navigation ----
    BACK = 40100
    CENTER_VIEW = 40101
    ZOOM_IN = 40102
    ZOOM_OUT = 40103
    AUTOZOOM_DEFAULT = 40104
    AUTOZOOM_MAX = 40105
    FEATUREFINDER_DIRECT = 40106
    FEATUREFINDER_ZOOM = 40112
    FEATUREFINDER_CLEAR = 40113
    AUTOZOOM_FILAMENT = 40114
    FEATUREFINDER_RESUME = 40115
    FEATUREFINDER_DIRECT_SCAN = 40116
    FEATUREFINDER_PT = 40117
    FEATUREFINDER_PT_SCAN = 40118
    FEATUREFINDER_LA = 40119
    FEATUREFINDER_LA_SCAN = 40120
    # ---- views (STANDARD + View1.. map to presets) ----
    STANDARD_VIEW = 40200
    # 40201..40240 = View1..View40 handled numerically
    # ---- antialiasing ----
    AA_1X = 40300
    AA_4X = 40301
    AA_9X = 40302
    AA_16X = 40303
    # ---- iterations ----
    RESET_ITERATIONS = 40400
    INCREASE_ITERATIONS_1P5X = 40401
    INCREASE_ITERATIONS_6X = 40402
    INCREASE_ITERATIONS_24X = 40403
    DECREASE_ITERATIONS = 40404
    ITER_32BIT = 40405
    ITER_64BIT = 40406
    # ---- palette ----
    PALETTE_TYPE_0 = 40500
    PALETTE_TYPE_1 = 40501
    PALETTE_TYPE_2 = 40502
    PALETTE_TYPE_3 = 40503
    PALETTE_TYPE_4 = 40504
    CREATE_NEW_PALETTE = 40510
    PALETTE_DEPTH_NEXT = 40511
    PALETTE_ROTATE = 40512
    # ---- orbit / files ----
    SAVE_REF_ORBIT = 40600
    LOAD_REF_ORBIT = 40601
    SAVE_LOCATION = 40602
    SAVE_PNG = 40603
    SAVE_ITERS_TEXT = 40604
    # ---- algorithm ----
    ALG_AUTO = 40700
    # ---- abort ----
    ABORT = 40900

    @staticmethod
    def view(n: int) -> int:
        """View preset command id (View1.. = 40201..)."""
        return 40200 + n


@dataclass(frozen=True)
class HotKey:
    key: str
    shift: bool = False
    ctrl: bool = False
    alt: bool = False

    def label(self) -> str:
        mods = "".join(m for m, on in
                       (("Ctrl+", self.ctrl), ("Alt+", self.alt),
                        ("Shift+", self.shift)) if on)
        return mods + self.key.upper()


@dataclass(frozen=True)
class CommandEntry:
    command: int
    hotkey: HotKey | None
    label: str


# the single source of truth the front-ends walk (CommandCatalog.h kCommands)
K_COMMANDS: tuple[CommandEntry, ...] = (
    CommandEntry(FractalCommand.SHOW_HOTKEYS, HotKey("h"), "Show hotkeys"),
    CommandEntry(FractalCommand.ZOOM_IN, HotKey("z"), "Zoom in here"),
    CommandEntry(FractalCommand.ZOOM_OUT, HotKey("z", shift=True), "Zoom out"),
    CommandEntry(FractalCommand.BACK, HotKey("b"), "Back"),
    CommandEntry(FractalCommand.CENTER_VIEW, HotKey("c"), "Center view"),
    CommandEntry(FractalCommand.AUTOZOOM_DEFAULT, HotKey("a"),
                 "Autozoom (default)"),
    CommandEntry(FractalCommand.AUTOZOOM_MAX, HotKey("a", shift=True),
                 "Autozoom (max)"),
    CommandEntry(FractalCommand.FEATUREFINDER_DIRECT, HotKey("f"),
                 "Find feature"),
    CommandEntry(FractalCommand.FEATUREFINDER_ZOOM, HotKey("g"),
                 "Zoom to feature"),
    CommandEntry(FractalCommand.FEATUREFINDER_DIRECT_SCAN,
                 HotKey("n", ctrl=True),
                 "Find periodic point: direct scan"),
    CommandEntry(FractalCommand.FEATUREFINDER_PT_SCAN,
                 HotKey("m", ctrl=True),
                 "Find periodic point: PT scan"),
    CommandEntry(FractalCommand.FEATUREFINDER_LA_SCAN,
                 HotKey(",", ctrl=True),
                 "Find periodic point: LA scan"),
    CommandEntry(FractalCommand.STANDARD_VIEW, HotKey("0"), "Home view"),
    CommandEntry(FractalCommand.INCREASE_ITERATIONS_1P5X, HotKey("i"),
                 "Iterations ×1.5"),
    CommandEntry(FractalCommand.DECREASE_ITERATIONS, HotKey("i", shift=True),
                 "Iterations ÷1.5"),
    CommandEntry(FractalCommand.RESET_ITERATIONS, HotKey("r"),
                 "Reset iterations"),
    CommandEntry(FractalCommand.PALETTE_DEPTH_NEXT, HotKey("p"),
                 "Next palette depth"),
    CommandEntry(FractalCommand.CREATE_NEW_PALETTE, HotKey("n"),
                 "New random palette"),
    CommandEntry(FractalCommand.SAVE_PNG, HotKey("s"), "Save PNG"),
    CommandEntry(FractalCommand.ABORT, HotKey("q", ctrl=True), "Abort"),
    CommandEntry(FractalCommand.EXIT, HotKey("x"), "Exit"),
)


def find_command_for_key(key: str, shift=False, ctrl=False,
                         alt=False) -> int:
    for e in K_COMMANDS:
        hk = e.hotkey
        if hk and hk.key == key.lower() and hk.shift == shift and \
                hk.ctrl == ctrl and hk.alt == alt:
            return e.command
    return FractalCommand.NONE


class PortableCommandHandlers:
    """Applies catalog commands to a Fractal engine
    (PortableCommandHandlers.cpp analogue). Front-ends translate input
    events to command ids and call dispatch()."""

    DEFAULT_ITERATIONS = 256

    def __init__(self, fractal, on_exit: Callable | None = None):
        self.fractal = fractal
        self.on_exit = on_exit
        self.view_history: list = []
        self.last_feature = None
        self.feature_summaries = []
        self.messages: list[str] = []

    def _push_history(self):
        self.view_history.append(
            (self.fractal.ptz, self.fractal.num_iterations))
        del self.view_history[:-64]

    def dispatch(self, command: int, **kw) -> bool:
        f = self.fractal
        c = command
        FC = FractalCommand
        if c == FC.SHOW_HOTKEYS:
            self.messages.append("\n".join(
                f"{(e.hotkey.label() if e.hotkey else ''):<12} {e.label}"
                for e in K_COMMANDS))
        elif c == FC.ZOOM_IN:
            self._push_history()
            if "x" in kw and "y" in kw:
                f.zoom_at(kw["x"], kw["y"], kw.get("scale", 2.0))
            else:
                f.zoom(kw.get("scale", 2.0))
        elif c == FC.ZOOM_OUT:
            self._push_history()
            f.zoom(1.0 / kw.get("scale", 2.0))
        elif c == FC.BACK:
            if self.view_history:
                ptz, iters = self.view_history.pop()
                f.set_view(ptz, square_aspect=False)
                f.num_iterations = iters
        elif c == FC.CENTER_VIEW:
            self._push_history()
            f.zoom_at(kw["x"], kw["y"], 1.0)
        elif c in (FC.AUTOZOOM_DEFAULT, FC.AUTOZOOM_MAX,
                   FC.AUTOZOOM_FILAMENT):
            from fractalshark_tpu_torch.engine.autozoom import (
                AutoZoomer, AutoZoomHeuristic)
            h = {FC.AUTOZOOM_DEFAULT: AutoZoomHeuristic.DEFAULT,
                 FC.AUTOZOOM_MAX: AutoZoomHeuristic.MAX,
                 FC.AUTOZOOM_FILAMENT: AutoZoomHeuristic.FILAMENT_TIP}[c]
            self._push_history()
            AutoZoomer(f, h).run(kw.get("steps", 1))
        elif c == FC.FEATUREFINDER_DIRECT:
            self.last_feature = f.try_find_periodic_point(
                max_period=kw.get("max_period"))
            self.messages.append(
                f"feature: period {self.last_feature.period}"
                if self.last_feature else "no feature found")
        elif c in (FC.FEATUREFINDER_DIRECT_SCAN, FC.FEATUREFINDER_PT_SCAN,
                   FC.FEATUREFINDER_LA_SCAN):
            # scan variants share the evaluator; cell grid per the
            # reference orchestrator (FeatureFinderOrchestrator.cpp:537)
            from fractalshark_tpu_torch.engine.feature_finder import (
                find_periodic_points_scan)
            mode = ("pt" if c in (FC.FEATUREFINDER_PT_SCAN,
                                  FC.FEATUREFINDER_LA_SCAN)
                    else "direct")
            feats = find_periodic_points_scan(
                f.ptz, kw.get("max_period") or
                min(f.num_iterations, 1_000_000),
                grid=kw.get("grid", (12, 12)), mode=mode)
            self.feature_summaries = feats
            self.last_feature = feats[0] if feats else None
            self.messages.append(
                f"found {len(feats)} periodic points" if feats
                else "No periodic points found.")
        elif c == FC.FEATUREFINDER_ZOOM:
            if self.last_feature is not None:
                self._push_history()
                f.zoom_to_feature(self.last_feature)
        elif c == FC.FEATUREFINDER_CLEAR:
            self.last_feature = None
        elif c == FC.STANDARD_VIEW:
            self._push_history()
            f.set_view_preset(0)
        elif 40201 <= c <= 40240:
            self._push_history()
            f.set_view_preset(c - 40200)
        elif c in (FC.AA_1X, FC.AA_4X, FC.AA_9X, FC.AA_16X):
            f.antialiasing = {FC.AA_1X: 1, FC.AA_4X: 2,
                              FC.AA_9X: 3, FC.AA_16X: 4}[c]
        elif c == FC.RESET_ITERATIONS:
            f.num_iterations = self.DEFAULT_ITERATIONS
        elif c == FC.INCREASE_ITERATIONS_1P5X:
            f.num_iterations = int(f.num_iterations * 1.5)
        elif c == FC.INCREASE_ITERATIONS_6X:
            f.num_iterations = int(f.num_iterations * 6)
        elif c == FC.INCREASE_ITERATIONS_24X:
            f.num_iterations = int(f.num_iterations * 24)
        elif c == FC.DECREASE_ITERATIONS:
            f.num_iterations = max(16, int(f.num_iterations / 1.5))
        elif 40500 <= c <= 40504:
            from fractalshark_tpu_torch.core.palette import PALETTE_TYPES
            f.palette.use_palette_type(PALETTE_TYPES[c - 40500])
        elif c == FC.CREATE_NEW_PALETTE:
            f.palette.use_palette_type("Random")
            f.palette.create_new_random_palette()
        elif c == FC.PALETTE_DEPTH_NEXT:
            f.palette.next_depth()
        elif c == FC.PALETTE_ROTATE:
            f.palette.rotate(kw.get("delta", 16), f.num_iterations)
        elif c == FC.SAVE_REF_ORBIT:
            f.save_ref_orbit(kw["path"], kw.get("compression", "simple"))
        elif c == FC.LOAD_REF_ORBIT:
            f.load_ref_orbit(kw["path"])
        elif c == FC.SAVE_LOCATION:
            from fractalshark_tpu_torch.io.saved_location import (
                SavedLocation, serialize)
            with open(kw["path"], "a") as fh:
                fh.write(serialize(SavedLocation(
                    f.width, f.height, f.ptz.min_x, f.ptz.min_y,
                    f.ptz.max_x, f.ptz.max_y, f.num_iterations,
                    f.antialiasing, kw.get("description", ""))) + "\n")
        elif c == FC.SAVE_PNG:
            f.save_png(kw.get("path", "fractal.png"))
        elif c == FC.SAVE_ITERS_TEXT:
            f.save_iters_as_text(kw["path"])
        elif c == FC.ALG_AUTO:
            f.algorithm_name = "AUTO"
        elif c == FC.CUR_POS:
            self.messages.append(
                f"center=({f.ptz.pt_x.to_string(30)}, "
                f"{f.ptz.pt_y.to_string(30)}) "
                f"zoom={f.ptz.zoom_factor.to_string(8)}")
        elif c == FC.ABORT:
            from fractalshark_tpu_torch.utils.aux import AbortMonitor
            AbortMonitor.get_global().abort()
        elif c == FC.EXIT:
            if self.on_exit:
                self.on_exit()
            return False
        return True
