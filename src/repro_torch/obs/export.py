"""Prometheus text-format rendering of a :class:`Registry` snapshot
(a copy of the reference's ``repro/obs/export.py``, which imports no jax).

Stdlib-only (no ``prometheus_client`` dependency): we emit the
`text exposition format
<https://prometheus.io/docs/instrumenting/exposition_formats/>`_
directly -- ``# TYPE`` headers, label-decorated sample lines, and the
``_count`` / ``_sum`` / quantile triplet per histogram (rendered as a
Prometheus *summary*, the type for client-side quantiles).

Name mapping: registry names are path-like (``solver/step_s``); the
exposition grammar only allows ``[a-zA-Z_:][a-zA-Z0-9_:]*``, so every
illegal character becomes ``_`` (``solver/step_s`` ->
``solver_step_s``).  Registry label syntax (``name{k=v,...}``) is
parsed back out of the snapshot keys and re-emitted as quoted
Prometheus labels.

:func:`parse_prometheus_text` is the inverse used by the smoke tests
(and by anyone without a scraper handy): it validates the grammar line
by line and returns ``{metric_name: {frozenset(labels): value}}``.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE = re.compile(
    r"([a-zA-Z_:][a-zA-Z0-9_:]*)"         # metric name
    r"(?:\{([^}]*)\})?"                   # optional {labels}
    r"\s+(\S+)\s*\Z")                     # value
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\Z')


def sanitize_name(name: str) -> str:
    """Map a registry metric name onto the Prometheus name grammar."""
    out = _NAME_FIX.sub("_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"name{k=v,k2=v2}"`` -> ``("name", {"k": "v", "k2": "v2"})``."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k] = v
    return name, labels


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_UNESCAPE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    return _UNESCAPE.sub(
        lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize_name(k)}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _value(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def render_prometheus(snapshot: dict, *, prefix: str = "") -> str:
    """Render a ``Registry.snapshot()`` as Prometheus text format.

    Args:
      snapshot: the ``{"counters": ..., "gauges": ..., "histograms": ...}``
        dict from :meth:`Registry.snapshot`.
      prefix: optional namespace prepended to every metric name
        (``prefix="repro_"`` yields ``repro_solver_step_s``).

    Returns the exposition body, terminated by a newline (required by
    the format for non-empty bodies).
    """
    lines = []

    def header(name, kind):
        lines.append(f"# TYPE {name} {kind}")

    # group label variants under one TYPE header per metric name
    def by_name(section):
        groups: Dict[str, list] = {}
        for key, val in sorted(section.items()):
            name, labels = split_key(key)
            groups.setdefault(prefix + sanitize_name(name), []) \
                  .append((labels, val))
        return groups

    for name, entries in by_name(snapshot.get("counters", {})).items():
        header(name, "counter")
        for labels, val in entries:
            lines.append(f"{name}{_labels(labels)} {_value(val)}")

    for name, entries in by_name(snapshot.get("gauges", {})).items():
        header(name, "gauge")
        for labels, val in entries:
            lines.append(f"{name}{_labels(labels)} {_value(val)}")

    for name, entries in by_name(snapshot.get("histograms", {})).items():
        header(name, "summary")
        for labels, summ in entries:
            for k, v in summ.items():
                if k.startswith("p") and k[1:].isdigit():
                    q = {**labels, "quantile": str(int(k[1:]) / 100.0)}
                    lines.append(f"{name}{_labels(q)} {_value(v)}")
            lines.append(f"{name}_count{_labels(labels)} "
                         f"{_value(summ['count'])}")
            lines.append(f"{name}_sum{_labels(labels)} "
                         f"{_value(summ['sum'])}")

    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> Dict[str, Dict[frozenset, float]]:
    """Parse/validate exposition text; the smoke tests' scraper.

    Returns ``{metric_name: {frozenset(label_pairs): value}}``.

    Raises:
      ValueError: on any line that is neither a comment, blank, nor a
        grammar-conforming sample line.
    """
    out: Dict[str, Dict[frozenset, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a valid sample: {line!r}")
        name, labelstr, valstr = m.groups()
        labels = {}
        if labelstr:
            for part in _split_labels(labelstr, lineno):
                lm = _LABEL.match(part)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: bad label pair {part!r}")
                labels[lm.group(1)] = _unescape(lm.group(2))
        try:
            value = float(valstr)
        except ValueError:
            raise ValueError(f"line {lineno}: bad value {valstr!r}")
        out.setdefault(name, {})[frozenset(labels.items())] = value
    return out


def _split_labels(labelstr: str, lineno: int):
    """Split ``k="v",k2="v2"`` on commas outside quotes."""
    parts, buf, in_q, esc = [], [], False, False
    for ch in labelstr:
        if esc:
            buf.append(ch)
            esc = False
        elif ch == "\\":
            buf.append(ch)
            esc = True
        elif ch == '"':
            buf.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if in_q:
        raise ValueError(f"line {lineno}: unterminated label quote")
    if buf:
        parts.append("".join(buf))
    return parts
