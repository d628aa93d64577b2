"""Run manifests — the artifact contract between pipeline steps (the
port's copy of the JAX package's `utils/manifest.py`).

The reference chains binaries through `{prefix}.senna.json` manifests
(`senna/src/run_manifest.rs:269-952`); downstream commands inherit
inputs (and even cell->pb partitions) via `--from`. Same schema spirit
here: a JSON document recording inputs, outputs, artifact kinds, and
key hyperparameters.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

import numpy as np


class ArtifactScale:
    """The numeric scale of a gene x component artifact
    (`run_manifest.rs:308-345`): reading a log-simplex table as a
    probability simplex gives ln(negative) — silent NaNs with no shape
    mismatch to catch it, so scale is detected from content and
    guarded at read time."""

    SIGNED = "signed"
    LOG_SIMPLEX_COLUMNS = "log_simplex_columns"
    PROBABILITY_SIMPLEX_COLUMNS = "probability_simplex_columns"

    @staticmethod
    def detect(m: np.ndarray, *, axis: int = 0) -> str:
        """Classify by content, independent of filename/bookkeeping
        (run_manifest.rs `ArtifactScale::detect`). `axis` is the
        simplex axis (0 = each column sums to 1)."""
        m = np.asarray(m, np.float64)
        if m.size == 0:
            return ArtifactScale.SIGNED
        if np.all(np.abs(np.exp(m).sum(axis=axis) - 1.0) < 1e-2):
            return ArtifactScale.LOG_SIMPLEX_COLUMNS
        if np.all(m >= 0.0) and np.all(np.abs(m.sum(axis=axis) - 1.0) < 1e-2):
            return ArtifactScale.PROBABILITY_SIMPLEX_COLUMNS
        return ArtifactScale.SIGNED

    @staticmethod
    def ensure(m: np.ndarray, want: str, what: str, *, axis: int = 0):
        got = ArtifactScale.detect(m, axis=axis)
        if got != want:
            raise ValueError(
                f"{what}: expected {want} but the values are {got} — reading "
                "one as the other silently produces NaN or a degenerate model"
            )

    @staticmethod
    def to_linear_simplex(m: np.ndarray, *, axis: int = 0) -> np.ndarray:
        """Read any simplex-scale artifact as probabilities; raises on
        signed input (the guard the CLI layout/plot handlers use in
        place of the old all-negative heuristic)."""
        got = ArtifactScale.detect(m, axis=axis)
        if got == ArtifactScale.LOG_SIMPLEX_COLUMNS:
            return np.exp(np.asarray(m, np.float64))
        if got == ArtifactScale.PROBABILITY_SIMPLEX_COLUMNS:
            return np.asarray(m, np.float64)
        raise ValueError(
            "expected a (log-)simplex artifact but the values are signed"
        )


@dataclass
class RunManifest:
    command: str
    inputs: dict[str, Any] = field(default_factory=dict)
    outputs: dict[str, str] = field(default_factory=dict)
    params: dict[str, Any] = field(default_factory=dict)
    # per-output artifact metadata: name -> {"kind", "scale"}
    # (run_manifest.rs artifact-kind bookkeeping)
    artifacts: dict[str, dict[str, str]] = field(default_factory=dict)
    # wall-clock stage breakdown in seconds (the reference exposes this
    # through progress bars; persisting it makes runs benchmarkable —
    # scaling_bench.py --cli-* reads it back)
    timings: dict[str, float] = field(default_factory=dict)
    engine: str = "legume-tpu"

    def record_artifact(self, name: str, path: str, kind: str, scale: str):
        self.outputs[name] = path
        self.artifacts[name] = {"kind": kind, "scale": scale}

    def artifact_scale(self, name: str) -> str | None:
        return self.artifacts.get(name, {}).get("scale")

    def save(self, prefix: str, suffix: str = "senna.json") -> str:
        path = f"{prefix}.{suffix}"
        Path(path).write_text(json.dumps(asdict(self), indent=2, default=str))
        return path

    @classmethod
    def load(cls, path: str) -> "RunManifest":
        doc = json.loads(Path(path).read_text())
        return cls(
            command=doc.get("command", ""),
            inputs=doc.get("inputs", {}),
            outputs=doc.get("outputs", {}),
            params=doc.get("params", {}),
            artifacts=doc.get("artifacts", {}),
            timings=doc.get("timings", {}),
            engine=doc.get("engine", ""),
        )


def manifest_path(run: str) -> str:
    """The manifest of a `--from` value: the path itself or `{run}.senna.json`."""
    return run if run.endswith(".json") else run + ".senna.json"


def save_manifest_back(manifest: RunManifest, src: str) -> None:
    """Write `manifest` back to the file `src` it was loaded from."""
    suffix = "senna.json" if src.endswith(".senna.json") else "json"
    manifest.save(src[: -len(suffix) - 1], suffix)
