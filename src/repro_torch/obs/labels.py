"""The ``cta{i}/{role}`` warpgroup-label convention — single source of truth.

Every subsystem that names a warpgroup lane (engine thread labels, gantt
tags, stall attribution, counter tracks, Perfetto thread names) goes through
these helpers.  Before this module, ``core.gantt`` and
``analysis.critical_path`` each re-parsed the convention by hand and could
drift independently; now both call here.

Vocabulary
  * **label** — ``cta{idx}/{role-instance}``, e.g. ``cta3/consumer1``
    (``cta3/wg0`` for traces built outside the kernel IR);
  * **role instance** — the per-warpgroup name, e.g. ``consumer1``;
  * **role** — the declared role with the instance index stripped, e.g.
    ``consumer`` (aggregation key for cross-CTA views);
  * **gantt tag** — ``{lane}:{label}:{op-tag}``, e.g.
    ``mma:cta0/consumer1:QK`` (the legacy flat-interval encoding).

This module is deliberately import-free so anything (``core``, ``analysis``,
``obs``) can depend on it without cycles.
"""
from __future__ import annotations

from typing import Optional, Tuple

LABEL_SEP = "/"
TAG_SEP = ":"


def make_label(cta_idx: int, role_instance: str) -> str:
    """Compose the canonical warpgroup label: ``cta{idx}/{role_instance}``."""
    return f"cta{cta_idx}{LABEL_SEP}{role_instance}"


def split_label(label: str) -> Tuple[Optional[int], str]:
    """``"cta3/consumer1"`` -> ``(3, "consumer1")``.

    The CTA index is ``None`` when the label carries no parsable ``cta{i}``
    prefix (hand-built traces are allowed to use free-form labels)."""
    head, sep, inst = label.rpartition(LABEL_SEP)
    if not sep:
        return None, label
    if head.startswith("cta"):
        try:
            return int(head[3:]), inst
        except ValueError:
            pass
    return None, inst


def cta_of(label: str) -> Optional[int]:
    """CTA launch index behind a label, or ``None``."""
    return split_label(label)[0]


def role_of(label: str) -> str:
    """Declared role behind a warpgroup label: ``cta3/consumer1`` ->
    ``consumer``.  Labels carry the kernel IR's role-instance names
    (``producer``, ``consumer0``, ...; positional ``wg0`` only for traces
    built outside the IR); the cta prefix and instance index are stripped
    so per-role views aggregate across instances and CTAs."""
    inst = split_label(label)[1]
    stripped = inst.rstrip("0123456789")
    return stripped if stripped else inst


def split_gantt_tag(tag: str) -> Tuple[str, str, str]:
    """``"mma:cta0/consumer1:QK"`` -> ``("mma", "cta0/consumer1", "QK")``.
    Missing parts come back as ``""``."""
    lane, _, rest = tag.partition(TAG_SEP)
    label, _, op_tag = rest.partition(TAG_SEP)
    return lane, label, op_tag


def lane_of(tag: str) -> str:
    """Lane (``tma`` / ``mma`` / ``bubble``) of a gantt tag."""
    return split_gantt_tag(tag)[0]


def label_of(tag: str) -> str:
    """Warpgroup label embedded in a gantt tag."""
    return split_gantt_tag(tag)[1]
