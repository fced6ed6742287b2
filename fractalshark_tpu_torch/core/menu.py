"""Declarative menu tree over the command catalog.

Backend-agnostic data layer mirroring the reference's portable menu
(``FractalSharkLib/MenuTree.h`` Node/Rule/RadioGroup,
``MenuTreeDef.h`` canonical definition): the GUI shells (Win32 /
Linux there; the interactive console loop here) all walk ONE tree of
plain nodes — labels, command ids, enable rules, radio groups — and
render it however they like. Nodes are immutable and the tree is a
module-level constant, so walking is always safe (the reference's
stable-storage invariant holds trivially in Python).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from fractalshark_tpu_torch.core.commands import (FractalCommand as FC,
                                                  K_COMMANDS)


class Rule(enum.Enum):
    """Enable predicates (MenuTree.h Rule enum), evaluated against the
    PortableCommandHandlers instance at render time."""
    ALWAYS = 0
    IF_FEATURE_FOUND = 1
    IF_NR_CHECKPOINT = 2
    IF_HISTORY = 3


class RadioGroup(enum.Enum):
    NONE = 0
    ANTIALIASING = 1
    PALETTE_TYPE = 2
    PERTURBATION_MODE = 3


class Kind(enum.Enum):
    ITEM = 0
    SEP = 1
    POPUP = 2
    RADIO = 3


@dataclass(frozen=True)
class MenuNode:
    kind: Kind
    label: str = ""
    command: int | None = None
    kids: tuple["MenuNode", ...] = field(default_factory=tuple)
    rule: Rule = Rule.ALWAYS
    group: RadioGroup = RadioGroup.NONE


def item(label: str, command: int, rule: Rule = Rule.ALWAYS) -> MenuNode:
    return MenuNode(Kind.ITEM, label, command, rule=rule)


def radio(label: str, command: int, group: RadioGroup,
          rule: Rule = Rule.ALWAYS) -> MenuNode:
    return MenuNode(Kind.RADIO, label, command, rule=rule, group=group)


def sep() -> MenuNode:
    return MenuNode(Kind.SEP)


def popup(label: str, *kids: MenuNode,
          rule: Rule = Rule.ALWAYS) -> MenuNode:
    return MenuNode(Kind.POPUP, label, kids=tuple(kids), rule=rule)


# --------------------------------------------------------- the menu tree
# Structure mirrors MenuTreeDef.h's top-level grouping (Navigate /
# Feature Finder / Views / Iterations / Palette / AA / IO).

MENU: tuple[MenuNode, ...] = (
    item("Show Help", FC.SHOW_HOTKEYS),
    sep(),
    popup(
        "Navigate",
        item("Back", FC.BACK, rule=Rule.IF_HISTORY),
        sep(),
        item("Center View Here", FC.CENTER_VIEW),
        item("Zoom In Here", FC.ZOOM_IN),
        item("Zoom Out", FC.ZOOM_OUT),
        sep(),
        item("Autozoom Default", FC.AUTOZOOM_DEFAULT),
        item("Autozoom Max", FC.AUTOZOOM_MAX),
        item("Autozoom Filament Tip", FC.AUTOZOOM_FILAMENT),
        sep(),
        popup(
            "Feature Finder",
            item("Direct", FC.FEATUREFINDER_DIRECT),
            item("Direct Scan", FC.FEATUREFINDER_DIRECT_SCAN),
            item("PT Scan", FC.FEATUREFINDER_PT_SCAN),
            item("LA Scan", FC.FEATUREFINDER_LA_SCAN),
            sep(),
            item("Zoom to Found Feature", FC.FEATUREFINDER_ZOOM,
                 rule=Rule.IF_FEATURE_FOUND),
            item("Resume NR Refinement", FC.FEATUREFINDER_RESUME,
                 rule=Rule.IF_NR_CHECKPOINT),
            item("Clear Found Features", FC.FEATUREFINDER_CLEAR,
                 rule=Rule.IF_FEATURE_FOUND),
        ),
    ),
    popup(
        "Views",
        item("Standard View", FC.STANDARD_VIEW),
        *(item(f"View #{n}", 40200 + n) for n in range(1, 15)),
    ),
    popup(
        "Iterations",
        item("Iterations ×1.5", FC.INCREASE_ITERATIONS_1P5X),
        item("Iterations ÷1.5", FC.DECREASE_ITERATIONS),
        item("Reset Iterations", FC.RESET_ITERATIONS),
    ),
    popup(
        "Palette",
        item("Next Palette Depth", FC.PALETTE_DEPTH_NEXT),
        item("Rotate Palette", FC.PALETTE_ROTATE),
        item("Create New Random Palette", FC.CREATE_NEW_PALETTE),
    ),
    popup(
        "Antialiasing",
        radio("1x", FC.AA_1X, RadioGroup.ANTIALIASING),
        radio("4x", FC.AA_4X, RadioGroup.ANTIALIASING),
        radio("9x", FC.AA_9X, RadioGroup.ANTIALIASING),
        radio("16x", FC.AA_16X, RadioGroup.ANTIALIASING),
    ),
    popup(
        "File",
        item("Save Current Location", FC.SAVE_LOCATION),
        item("Save Image (PNG)", FC.SAVE_PNG),
        item("Save Iterations As Text", FC.SAVE_ITERS_TEXT),
        item("Save Reference Orbit", FC.SAVE_REF_ORBIT),
    ),
    sep(),
    item("Exit", FC.EXIT),
)


# ------------------------------------------------------------- utilities


def walk(nodes=MENU, depth: int = 0):
    """Yield (node, depth) in pre-order."""
    for n in nodes:
        yield n, depth
        if n.kind is Kind.POPUP:
            yield from walk(n.kids, depth + 1)


def validate(nodes=MENU) -> list[str]:
    """Catalog consistency (the reference's ValidateCommandCatalog
    static_assert analogue): every command id must exist. Returns a
    list of problems (empty = valid)."""
    known = {int(e.command) for e in K_COMMANDS}
    known |= set(range(40200, 40241))  # view presets, numeric range
    known |= {int(c) for c in FC}
    problems = []
    for n, _ in walk(nodes):
        if n.kind in (Kind.ITEM, Kind.RADIO):
            if n.command is None:
                problems.append(f"{n.label!r}: no command")
            elif int(n.command) not in known:
                problems.append(f"{n.label!r}: unknown command "
                                f"{int(n.command)}")
        if n.kind is Kind.RADIO and n.group is RadioGroup.NONE:
            problems.append(f"{n.label!r}: radio without group")
    return problems


def _enabled(node: MenuNode, handlers) -> bool:
    if handlers is None or node.rule is Rule.ALWAYS:
        return True
    if node.rule is Rule.IF_FEATURE_FOUND:
        return getattr(handlers, "last_feature", None) is not None
    if node.rule is Rule.IF_NR_CHECKPOINT:
        import os
        p = getattr(handlers, "nr_checkpoint_path", None)
        return bool(p) and os.path.exists(p)
    if node.rule is Rule.IF_HISTORY:
        return bool(getattr(handlers, "history", ()))
    return True


def _hotkey_label(command: int) -> str:
    for e in K_COMMANDS:
        if int(e.command) == int(command):
            return e.hotkey.label()
    return ""


def render_text(handlers=None, nodes=MENU, checked=None) -> str:
    """Render the tree as indented text for the console shell (the
    Linux-GUI walker analogue). `checked` maps RadioGroup → command id
    of the active choice."""
    checked = checked or {}
    lines = []
    for n, depth in walk(nodes):
        pad = "  " * depth
        if n.kind is Kind.SEP:
            lines.append(f"{pad}---")
        elif n.kind is Kind.POPUP:
            lines.append(f"{pad}[{n.label}]")
        else:
            mark = ""
            if n.kind is Kind.RADIO:
                mark = ("(*) " if checked.get(n.group) == n.command
                        else "( ) ")
            dis = "" if _enabled(n, handlers) else "  (disabled)"
            hk = _hotkey_label(n.command)
            hk = f"  [{hk}]" if hk else ""
            lines.append(f"{pad}{mark}{n.label}{hk}{dis}")
    return "\n".join(lines)
