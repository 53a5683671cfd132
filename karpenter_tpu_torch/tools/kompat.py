"""kompat: the Kubernetes compatibility-matrix CLI.

Re-creation of reference tools/kompat (pkg/kompat/kompat.go): a
``compatibility.yaml`` holds rows of
``{appVersion, minK8sVersion, maxK8sVersion}``; the tool answers "is app
X compatible with cluster Y", renders the matrix as a markdown table for
the docs site, and trims to the last N rows.  appVersion entries may use
a ``0.31.x`` wildcard patch, matching the reference's semver handling.

    python -m karpenter_tpu_torch.tools.kompat matrix.yaml --last-n 5
    python -m karpenter_tpu_torch.tools.kompat matrix.yaml \
        --app-version 0.31.0 --k8s-version 1.27
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Compatibility:
    app_version: str
    min_k8s: str
    max_k8s: str


@dataclass
class Matrix:
    name: str
    rows: List[Compatibility]

    # ------------------------------------------------------------------ query
    def compatible(self, app_version: str, k8s_version: str) -> bool:
        """IsCompatible (kompat.go): the row whose appVersion matches (with
        x-wildcard patch) must bracket the k8s MINOR version — a cluster
        patch level ('1.28.2') is irrelevant to the bracket."""
        row = self.find(app_version)
        if row is None:
            raise KeyError(f"app version {app_version!r} not in matrix")
        k = _minor(k8s_version)
        return _minor(row.min_k8s) <= k <= _minor(row.max_k8s)

    def find(self, app_version: str) -> Optional[Compatibility]:
        want = _ver(app_version)
        for row in self.rows:
            if _ver_matches(row.app_version, want):
                return row
        return None

    def last_n(self, n: int) -> "Matrix":
        return Matrix(self.name, self.rows[-n:]) if n > 0 else self

    # ----------------------------------------------------------------- render
    def markdown(self) -> str:
        """The docs-site table (kompat's markdown output): one column per
        app version, min/max k8s rows."""
        versions = [r.app_version for r in self.rows]
        head = "| KUBERNETES | " + " | ".join(versions) + " |"
        sep = "|---" * (len(versions) + 1) + "|"
        mins = "| min | " + " | ".join(r.min_k8s for r in self.rows) + " |"
        maxs = "| max | " + " | ".join(r.max_k8s for r in self.rows) + " |"
        return "\n".join([head, sep, mins, maxs])


def _ver(s: str) -> Tuple[int, ...]:
    """Parse '1.27' / '0.31.2' into a comparable tuple; 'x' wildcards are
    handled by _ver_matches, not here."""
    return tuple(int(p) for p in str(s).split(".") if p != "x")


def _minor(s: str) -> Tuple[int, int]:
    """(major, minor) — the granularity the compatibility bracket uses."""
    v = _ver(s)
    return (v[0], v[1] if len(v) > 1 else 0)


def _ver_matches(pattern: str, want: Tuple[int, ...]) -> bool:
    parts = str(pattern).split(".")
    for i, p in enumerate(parts):
        if p == "x":
            return True  # wildcard: anything from here on matches
        if i >= len(want) or int(p) != want[i]:
            return False
    return len(want) == len(parts)


def load(path: str) -> Matrix:
    import yaml

    with open(path) as f:
        # BaseLoader keeps every scalar a STRING: safe_load would turn an
        # unquoted `maxK8sVersion: 1.30` into the float 1.3, silently
        # corrupting the bracket (the Go reference decodes into string
        # struct fields, so strings are the parity behavior)
        raw = yaml.load(f, Loader=yaml.BaseLoader)
    return parse(raw)


def parse(raw: dict) -> Matrix:
    rows = [
        Compatibility(
            app_version=str(c["appVersion"]),
            min_k8s=str(c["minK8sVersion"]),
            max_k8s=str(c["maxK8sVersion"]),
        )
        for c in raw.get("compatibility", [])
    ]
    return Matrix(name=str(raw.get("name", "")), rows=rows)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="kompat")
    parser.add_argument("file", help="compatibility.yaml path")
    parser.add_argument("--last-n", "-n", type=int, default=0,
                        help="only the last N app versions")
    parser.add_argument("--app-version", help="check this app version...")
    parser.add_argument("--k8s-version", help="...against this k8s version")
    args = parser.parse_args(argv)

    matrix = load(args.file).last_n(args.last_n)
    if args.app_version and args.k8s_version:
        try:
            ok = matrix.compatible(args.app_version, args.k8s_version)
        except KeyError:
            print(
                f"app version {args.app_version} not in matrix "
                f"({len(matrix.rows)} rows; note --last-n trims old rows)"
            )
            return 2
        print(
            f"{matrix.name} {args.app_version} is "
            f"{'compatible' if ok else 'NOT compatible'} with "
            f"Kubernetes {args.k8s_version}"
        )
        return 0 if ok else 1
    print(matrix.markdown())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
