"""Chart renderer: values-substituted manifests without helm.

The reference ships a helm chart (charts/karpenter/); this image has no
helm binary, so deploy/chart/ holds the same structure (Chart.yaml,
values.yaml, templates/) and this renderer implements the template
features the templates use:

- ``{{ .Values.dotted.path }}`` substitution with ``--set path=value``
  overrides,
- line-level conditionals — a line consisting solely of
  ``{{ if <cond> }}`` opens a block closed by a ``{{ end }}`` line
  (blocks nest); ``<cond>`` is ``and``-joined atoms, each
  ``.Values.path`` (truthy), ``not .Values.path``,
  ``.Values.path > <number>``, or ``eq .Values.path "<string>"`` (helm's
  string equality: the port's chart asks for a card only where
  ``controller.device`` is ``"cuda"``),
- ``{{ fail "message" }}`` — a render-time assertion: reaching it in an
  active block aborts the render (the helm ``fail`` analogue, used to
  refuse unsafe value combinations like ``replicas: 2`` without the
  shared store backend).

Enough for ``python -m karpenter_tpu_torch.tools.render_chart deploy/chart |
kubectl apply -f -``.  Rendering is strict: an unknown ``.Values`` path
or a leftover template expression is an error, never silently empty
(helm's default behavior of rendering ``<no value>`` has bitten everyone
at least once).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

_EXPR = re.compile(r"\{\{\s*\.Values\.([A-Za-z0-9_.]+)\s*\}\}")
_IF = re.compile(r"^\s*\{\{\s*if\s+(.+?)\s*\}\}\s*$")
_END = re.compile(r"^\s*\{\{\s*end\s*\}\}\s*$")
_FAIL = re.compile(r"^\s*\{\{\s*fail\s+\"([^\"]*)\"\s*\}\}\s*$")
_FALSY = {"", "0", "false", "no", "null", "~", "none"}


def _lookup(values: dict, dotted: str):
    cur = values
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(f".Values.{dotted} is not set")
        cur = cur[part]
    return cur


def _set_override(values: dict, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    cur = values
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
        if not isinstance(cur, dict):
            raise KeyError(f"--set {dotted}: {p} is not a mapping")
    cur[parts[-1]] = value


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    return str(v).strip().lower() not in _FALSY


def _eval_cond(cond: str, values: dict, name: str) -> bool:
    """``and``-joined atoms: ``.Values.p`` | ``not .Values.p`` |
    ``.Values.p > N`` | ``eq .Values.p "s"``."""
    for atom in (a.strip() for a in cond.split(" and ")):
        negate = False
        if atom.startswith("not "):
            negate, atom = True, atom[4:].strip()
        m = re.fullmatch(r'eq\s+\.Values\.([A-Za-z0-9_.]+)\s+"([^"]*)"', atom)
        if m:
            if (str(_lookup(values, m.group(1))) == m.group(2)) == negate:
                return False
            continue
        m = re.fullmatch(
            r"\.Values\.([A-Za-z0-9_.]+)(?:\s*>\s*([0-9.]+))?", atom
        )
        if not m:
            raise ValueError(f"{name}: unsupported if-condition {atom!r}")
        v = _lookup(values, m.group(1))
        if m.group(2) is not None:
            result = float(v) > float(m.group(2))
        else:
            result = _truthy(v)
        if negate:
            result = not result
        if not result:
            return False
    return True


def _apply_blocks(text: str, values: dict, name: str) -> str:
    """Resolve ``{{ if }}`` / ``{{ end }}`` / ``{{ fail }}`` lines; lines
    inside inactive blocks (and the directive lines themselves) drop."""
    out: List[str] = []
    stack: List[bool] = []
    for line in text.splitlines():
        m = _IF.match(line)
        if m:
            active = all(stack) and _eval_cond(m.group(1), values, name)
            stack.append(active)
            continue
        if _END.match(line):
            if not stack:
                raise ValueError(f"{name}: {{{{ end }}}} without {{{{ if }}}}")
            stack.pop()
            continue
        if not all(stack):
            continue
        m = _FAIL.match(line)
        if m:
            raise ValueError(f"{name}: {m.group(1)}")
        out.append(line)
    if stack:
        raise ValueError(f"{name}: unclosed {{{{ if }}}} block")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def render_template(text: str, values: dict, name: str = "") -> str:
    text = _apply_blocks(text, values, name)
    def sub(m: re.Match) -> str:
        v = _lookup(values, m.group(1))
        if isinstance(v, bool):  # JSON/YAML booleans, not Python's True
            return "true" if v else "false"
        if isinstance(v, (dict, list)):
            # a values entry written as a natural YAML map/list (tags,
            # slo_rules) renders as JSON, not Python repr — the settings
            # payload must stay parseable either way
            return json.dumps(v)
        return str(v)

    out = _EXPR.sub(sub, text)
    leftover = re.search(r"\{\{.*?\}\}", out)
    if leftover:
        raise ValueError(
            f"{name}: unsupported template expression {leftover.group(0)!r}"
        )
    return out


def render_chart(
    chart_dir: str, overrides: Optional[Dict[str, str]] = None
) -> List[str]:
    """All templates rendered against values.yaml (+ overrides), as a
    list of YAML document strings, template-name sorted."""
    import yaml

    chart = Path(chart_dir)
    if not (chart / "Chart.yaml").exists():
        raise FileNotFoundError(f"{chart_dir}: no Chart.yaml")
    # BaseLoader: version-ish scalars stay strings (same reasoning as
    # tools/kompat.py's loader)
    values = yaml.load(
        (chart / "values.yaml").read_text(), Loader=yaml.BaseLoader
    ) or {}
    for dotted, value in (overrides or {}).items():
        _set_override(values, dotted, value)
    docs: List[str] = []
    for tpl in sorted((chart / "templates").glob("*.yaml")):
        rendered = render_template(tpl.read_text(), values, name=tpl.name)
        if not rendered.strip():
            continue  # whole template inside a disabled {{ if }} block
        # validate every document parses before anything is emitted
        for doc in yaml.safe_load_all(rendered):
            if doc is None:
                continue
            if "kind" not in doc or "apiVersion" not in doc:
                raise ValueError(f"{tpl.name}: document missing kind/apiVersion")
            # embedded JSON payloads (settings configmap) must be valid at
            # RENDER time, not discovered at controller pod startup — an
            # unescaped quote in a --set value corrupts them silently
            if doc.get("kind") == "ConfigMap":
                for key, payload in (doc.get("data") or {}).items():
                    if key.endswith(".json"):
                        try:
                            json.loads(payload)
                        except json.JSONDecodeError as exc:
                            raise ValueError(
                                f"{tpl.name}: data[{key}] is not valid "
                                f"JSON after substitution: {exc}"
                            ) from None
        docs.append(rendered.rstrip() + "\n")
    return docs


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="render-chart")
    parser.add_argument("chart", help="chart directory (deploy/chart)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="PATH=VALUE",
        help="override a values path (repeatable)",
    )
    args = parser.parse_args(argv)
    overrides = {}
    for item in args.set:
        path, _, value = item.partition("=")
        if not _ or not path:
            raise SystemExit(f"--set expects PATH=VALUE, got {item!r}")
        overrides[path] = value
    try:
        docs = render_chart(args.chart, overrides)
    except (KeyError, ValueError) as exc:
        # stderr: stdout is documented to pipe into `kubectl apply -f -`
        print(f"render error: {exc}", file=sys.stderr)
        return 1
    print("---\n".join(docs), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
