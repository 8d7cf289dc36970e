"""Metrics exporters: Prometheus text exposition + JSON snapshots (a
copy of ``repro.obs.export`` over the port's registry).

``to_prometheus`` renders a :class:`MetricsRegistry` in the Prometheus
text exposition format (format 0.0.4: HELP/TYPE headers, cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count`` for histograms).
``parse_prometheus`` is the matching reader (the round-trip check of
``tests/test_torch_load.py`` and ``chip_smoke.py``) — it returns
``{(name, ((label, value), ...)): float}`` samples.

``write_metrics(registry, path)`` writes the JSON snapshot at ``path``
and the Prometheus exposition next to it (``.prom`` suffix).
"""

from __future__ import annotations

import json
import math
import os

from repro_torch.obs.registry import MetricsRegistry


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"  # Prometheus text-format spelling (zero-signal SQNR)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def to_prometheus(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in sorted(fam.children.items()):
            labels = dict(key)
            if fam.kind == "histogram":
                cum = 0
                for le, c in zip(list(fam.buckets) + [math.inf],
                                 child.counts):
                    cum += c
                    ll = dict(labels)
                    ll["le"] = "+Inf" if math.isinf(le) else _fmt_value(le)
                    lines.append(
                        f"{fam.name}_bucket{_fmt_labels(ll)} {cum}"
                    )
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(child.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {child.count}"
                )
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)} "
                    f"{_fmt_value(child.value)}"
                )
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse a text exposition back into ``{(name, labels_tuple): value}``.

    Covers exactly what ``to_prometheus`` emits (one sample per line,
    HELP/TYPE comments) — a format round-trip check, not a general
    Prometheus client."""
    samples: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelstr, valstr = rest.rsplit("}", 1)
            labels = []
            for part in _split_labels(labelstr):
                k, v = part.split("=", 1)
                labels.append((k, _unescape(v.strip('"'))))
            key = (name, tuple(sorted(labels)))
        else:
            name, valstr = line.rsplit(None, 1)
            key = (name, ())
            valstr = " " + valstr
        v = valstr.strip()
        samples[key] = math.inf if v == "+Inf" else float(v)  # float("NaN") ok
    return samples


def _split_labels(s: str) -> list:
    out, cur, in_str = [], "", False
    for ch in s:
        if ch == '"' and not cur.endswith("\\"):
            in_str = not in_str
        if ch == "," and not in_str:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


def _unescape(s: str) -> str:
    return (
        s.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def _sanitize(obj):
    """NaN -> None, recursively: ``json.dump`` would emit a bare ``NaN``
    token (invalid strict JSON) for zero-signal SQNR gauges otherwise."""
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def to_json(registry: MetricsRegistry, extra: dict | None = None) -> dict:
    out = {"metrics": _sanitize(registry.snapshot())}
    if extra:
        out.update(_sanitize(extra))
    return out


def write_metrics(registry: MetricsRegistry, path: str,
                  extra: dict | None = None) -> tuple:
    """Write the JSON snapshot at ``path`` and the Prometheus text
    exposition beside it; returns (json_path, prom_path)."""
    snap = to_json(registry, extra)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, default=_json_default)
    prom_path = os.path.splitext(path)[0] + ".prom"
    with open(prom_path, "w") as f:
        f.write(to_prometheus(registry))
    return path, prom_path


def _json_default(o):
    if isinstance(o, float):
        return o
    return str(o)
