"""Per-family boot user-data generators (reference
pkg/providers/amifamily/bootstrap/).

The reference ships one Bootstrapper per AMI family — a MIME-multipart
shell script for AL2/Ubuntu (eksbootstrap.go), a TOML settings document
for Bottlerocket (bottlerocket.go:37-92), a PowerShell block for Windows,
and a verbatim passthrough for Custom (custom.go).  The three families
here mirror that split with distinct formats:

- ``standard``    -> :class:`ShellBootstrap` (MIME multipart + shell)
- ``accelerated`` -> :class:`TomlBootstrap` (settings document; the OS
  owns the merge, so user settings are overwritten key-by-key)
- ``custom``      -> :class:`CustomBootstrap` (verbatim passthrough)

Every generator is DETERMINISTIC for equivalent input (sorted labels,
taints, and settings keys): user data feeds the launch-template options
hash, and spurious ordering differences would churn templates on every
reconcile (the reference calls this out at eksbootstrap.go:44 and keys
template reuse on the hash, launchtemplate.go:99-126).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple

from karpenter_tpu_torch.api.objects import Taint

MIME_BOUNDARY = "//"
MIME_HEADER = (
    "MIME-Version: 1.0\n"
    'Content-Type: multipart/mixed; boundary="//"\n'
)


@dataclass
class BootstrapConfig:
    """Everything a family needs to write boot configuration
    (reference bootstrap.go Options struct)."""

    cluster_name: str = ""
    cluster_endpoint: str = ""
    ca_bundle: str = ""
    node_pool: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    max_pods: Optional[int] = None
    cluster_dns: Tuple[str, ...] = ()
    system_reserved: Dict[str, str] = field(default_factory=dict)
    kube_reserved: Dict[str, str] = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    custom_user_data: str = ""


class Bootstrapper(Protocol):
    def script(self) -> str: ...


def _kubelet_extra_args(cfg: BootstrapConfig) -> List[str]:
    """Shared --kubelet-extra-args assembly (bootstrap.go:80-118), with
    deterministic ordering."""
    args: List[str] = []
    if cfg.labels:
        joined = ",".join(f"{k}={cfg.labels[k]}" for k in sorted(cfg.labels))
        args.append(f'--node-labels="{joined}"')
    if cfg.taints:
        joined = ",".join(
            f"{t.key}={t.value}:{t.effect}"
            for t in sorted(cfg.taints, key=lambda t: (t.key, t.value, t.effect))
        )
        args.append(f'--register-with-taints="{joined}"')
    for name, m in (
        ("--system-reserved", cfg.system_reserved),
        ("--kube-reserved", cfg.kube_reserved),
        ("--eviction-hard", cfg.eviction_hard),
    ):
        if m:
            joined = ",".join(f"{k}={m[k]}" for k in sorted(m))
            args.append(f'{name}="{joined}"')
    return args


class ShellBootstrap:
    """MIME-multipart shell bootstrap — the ``standard`` family
    (reference eksbootstrap.go:44-121).

    Custom user data rides as its own MIME part BEFORE the bootstrap
    part, so user hooks run first; a custom part that is already a MIME
    document is spliced in part-by-part rather than double-wrapped
    (eksbootstrap.go:123-140).
    """

    def __init__(self, cfg: BootstrapConfig):
        self.cfg = cfg

    def script(self) -> str:
        parts: List[str] = []
        custom = self.cfg.custom_user_data.strip()
        if custom:
            parts.extend(self._custom_parts(custom))
        parts.append(self._bootstrap_part())
        out = [MIME_HEADER]
        for p in parts:
            out.append(f"--{MIME_BOUNDARY}")
            out.append('Content-Type: text/x-shellscript; charset="us-ascii"')
            out.append("")
            out.append(p)
        out.append(f"--{MIME_BOUNDARY}--")
        return "\n".join(out)

    def _custom_parts(self, custom: str) -> List[str]:
        if custom.startswith("MIME-Version:") or custom.startswith("Content-Type:"):
            # already multipart: splice its parts through unchanged,
            # honoring the document's OWN boundary (eksbootstrap.go:123-140
            # re-parses rather than assuming the karpenter boundary)
            m = re.search(r'boundary="?([^"\n]+)"?', custom)
            boundary = m.group(1) if m else MIME_BOUNDARY
            body = custom.split(f"--{boundary}")
            parts = [
                seg.split("\n\n", 1)[-1].strip()
                for seg in body[1:]
                if seg.strip() and seg.strip() != "--"
            ]
            # unparseable multipart: pass the whole document through as
            # one part rather than silently dropping the user's hooks
            return parts or [custom]
        return [custom]

    def _bootstrap_part(self) -> str:
        cfg = self.cfg
        cmd = [
            f"/etc/node/bootstrap.sh '{cfg.cluster_name}'",
            f"--apiserver-endpoint '{cfg.cluster_endpoint}'",
        ]
        if cfg.ca_bundle:
            cmd.append(f"--b64-cluster-ca '{cfg.ca_bundle}'")
        if cfg.cluster_dns:
            cmd.append(f"--dns-cluster-ip '{cfg.cluster_dns[0]}'")
        if cfg.max_pods is not None:
            # explicit pod density disables the interface-derived default
            # (eksbootstrap.go:74-77)
            cmd.append("--use-max-pods false")
        args = _kubelet_extra_args(cfg)
        if cfg.max_pods is not None:
            args.append(f"--max-pods={cfg.max_pods}")
        if args:
            cmd.append(f"--kubelet-extra-args '{' '.join(args)}'")
        return "\n".join(
            [
                "#!/bin/bash -xe",
                "exec > >(tee /var/log/user-data.log|logger -t user-data -s 2>/dev/console) 2>&1",
                " \\\n".join(cmd),
            ]
        )


class TomlBootstrap:
    """Settings-document bootstrap — the ``accelerated`` family
    (reference bottlerocket.go:37-92).

    Custom user data is parsed as a flat ``[section]`` / ``key = value``
    document and controller-owned keys are overwritten on top, mirroring
    the reference's mergo.MergeWithOverwrite semantics: the user may add
    arbitrary settings but cannot unpin cluster identity, labels, or
    taints.
    """

    SECTION = "settings.kubernetes"

    def __init__(self, cfg: BootstrapConfig):
        self.cfg = cfg

    def script(self) -> str:
        cfg = self.cfg
        doc = parse_settings(cfg.custom_user_data)
        k8s = doc.setdefault(self.SECTION, {})
        k8s["cluster-name"] = _q(cfg.cluster_name)
        k8s["api-server"] = _q(cfg.cluster_endpoint)
        if cfg.ca_bundle:
            k8s["cluster-certificate"] = _q(cfg.ca_bundle)
        if cfg.max_pods is not None:
            k8s["max-pods"] = str(cfg.max_pods)
        if cfg.cluster_dns:
            k8s["cluster-dns-ip"] = _q(cfg.cluster_dns[0])
        labels = doc.setdefault(f"{self.SECTION}.node-labels", {})
        for k in sorted(cfg.labels):
            labels[_q(k)] = _q(cfg.labels[k])
        if cfg.taints:
            taints = doc.setdefault(f"{self.SECTION}.node-taints", {})
            by_key: Dict[str, List[str]] = {}
            for t in cfg.taints:
                by_key.setdefault(t.key, []).append(f"{t.value}:{t.effect}")
            for k in sorted(by_key):
                taints[_q(k)] = "[" + ", ".join(_q(v) for v in sorted(by_key[k])) + "]"
        for name, m in (
            ("system-reserved", cfg.system_reserved),
            ("kube-reserved", cfg.kube_reserved),
            ("eviction-hard", cfg.eviction_hard),
        ):
            if m:
                sec = doc.setdefault(f"{self.SECTION}.{name}", {})
                for k in sorted(m):
                    sec[_q(k)] = _q(m[k])
        return emit_settings(doc)


class CustomBootstrap:
    """Verbatim passthrough — the ``custom`` family (reference
    custom.go): the user owns the whole boot document; nothing is
    merged, prefixed, or validated."""

    def __init__(self, cfg: BootstrapConfig):
        self.cfg = cfg

    def script(self) -> str:
        return self.cfg.custom_user_data


def _q(s: str) -> str:
    return '"' + str(s).replace('"', '\\"') + '"'


def parse_settings(text: str) -> Dict[str, Dict[str, str]]:
    """Minimal flat-TOML reader: ``[section]`` headers and ``key = value``
    lines.  Anything unparseable is ignored rather than fatal — custom
    user data is user input (bottlerocket.go:38-41 treats a parse error
    as invalid UserData; here the controller degrades to its own
    settings so one bad line can't wedge provisioning)."""
    out: Dict[str, Dict[str, str]] = {}
    section = ""
    for raw in (text or "").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip()
            out.setdefault(section, {})
        elif "=" in line and section:
            k, v = line.split("=", 1)
            out[section][k.strip()] = v.strip()
    return out


def emit_settings(doc: Dict[str, Dict[str, str]]) -> str:
    """Deterministic flat-TOML writer (sections and keys sorted)."""
    chunks: List[str] = []
    for section in sorted(doc):
        body = doc[section]
        if not body:
            continue
        chunks.append(f"[{section}]")
        for k in sorted(body):
            chunks.append(f"{k} = {body[k]}")
        chunks.append("")
    return "\n".join(chunks).rstrip() + "\n"
