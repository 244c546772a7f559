"""The learned per-op-class cost model (numpy ridge over log features).

The port's counterpart of ``flexflow_tpu/costmodel/model.py``, with the
same regression, split, hull, serialized form and native table, so that
one corpus trains the same coefficients in either package. One small
regression per op class (LINEAR, LAYERNORM, MULTIHEAD_ATTENTION:flash,
...), trained on the rows of ``costmodel/corpus.py``: features are the
log-space sharded-work vector, targets ``log(measured_seconds /
work_div)`` for the forward and the backward, so the model predicts the
per-device compute seconds the search's ``node_cost`` needs. A ridge
model in log space is a learned roofline (``t ~ flops^a * bytes^b`` with
per-class constants).

Confidence comes from class coverage (rows seen) and the feature hull,
the per-class min/max of every feature over the training rows: a query
outside it (plus ``HULL_MARGIN``) is an extrapolation, and the native
evaluator prices that op analytically instead.

Discovery differs from the JAX package's in two places. The default
file is the repo root's ``COSTMODEL_GPU.json`` (``FFS_COSTMODEL_FILE``
overrides it; ``FFS_NO_LEARNED_COSTS=1`` turns the table off), and the
platform gate reads the platform of the model's torch device
(``obs/artifacts.py`` ``device_identity``: ``"gpu"`` or ``"cpu"``), never
whether a card is present, so that a compile on the CPU of a host with a
card never prices with a card's table.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.costmodel.corpus import (CORPUS_SCHEMA_VERSION,
                                                 FEATURE_NAMES, featurize,
                                                 row_class, row_key)

MODEL_SCHEMA_VERSION = 1

# Per-op-class coverage gate: below this many training rows a class is
# not exported to the native table (the search keeps analytic pricing
# for it). 8 rows over a 4-feature model is where the ridge solution
# stops being memorization.
MIN_CLASS_ROWS = 8

# Hull slack in log units (about 2x in linear space).
HULL_MARGIN = 0.7

RIDGE_LAMBDA = 1e-3

# Floor for targets and predictions (seconds): keeps log() finite.
_T_FLOOR = 1e-9

# the default model file at the repo root (``costmodel train`` writes it)
DEFAULT_MODEL_FILE = "COSTMODEL_GPU.json"


def _split_test(rows: List[Dict[str, Any]], test_frac: float) -> np.ndarray:
    """Deterministic held-out mask: exactly floor(n * test_frac) rows,
    chosen by row-key CRC rank (stable across runs and row order)."""
    mask = np.zeros(len(rows), dtype=bool)
    n_test = int(len(rows) * max(0.0, test_frac))
    if n_test <= 0:
        return mask
    ranked = sorted(range(len(rows)),
                    key=lambda i: (zlib.crc32(repr(row_key(rows[i]))
                                              .encode()), i))
    for i in ranked[:n_test]:
        mask[i] = True
    return mask


def _ridge(X: np.ndarray, y: np.ndarray, lam: float) -> np.ndarray:
    """Ridge solve with intercept (intercept unregularized)."""
    Xb = np.hstack([np.ones((X.shape[0], 1)), X])
    d = Xb.shape[1]
    reg = lam * np.eye(d)
    reg[0, 0] = 0.0
    return np.linalg.solve(Xb.T @ Xb + reg, Xb.T @ y)


def _err(coef: np.ndarray, X: np.ndarray, y: np.ndarray) -> float:
    """Median |log(pred/actual)|: a multiplicative error."""
    if X.shape[0] == 0:
        return 0.0
    pred = np.hstack([np.ones((X.shape[0], 1)), X]) @ coef
    return float(np.median(np.abs(pred - y)))


class ClassModel:
    """Trained regression of one op class."""

    def __init__(self, coef_fwd, coef_bwd, fmin, fmax, n_train, n_test,
                 err_fwd, err_bwd):
        self.coef_fwd = np.asarray(coef_fwd, dtype=np.float64)
        self.coef_bwd = np.asarray(coef_bwd, dtype=np.float64)
        self.fmin = np.asarray(fmin, dtype=np.float64)
        self.fmax = np.asarray(fmax, dtype=np.float64)
        self.n_train = int(n_train)
        self.n_test = int(n_test)
        self.err_fwd = float(err_fwd)
        self.err_bwd = float(err_bwd)

    @property
    def err_factor(self) -> float:
        """Held-out multiplicative error of the forward as a factor (1.0
        is perfect): exp(median |log(pred/actual)|)."""
        return float(math.exp(self.err_fwd))

    def hull_violation(self, f: np.ndarray) -> float:
        """Total log units outside the trained feature range (0 inside)."""
        return float(np.sum(np.maximum(0.0, self.fmin - f)
                            + np.maximum(0.0, f - self.fmax)))

    def predict_log(self, f: np.ndarray, bwd: bool = False) -> float:
        coef = self.coef_bwd if bwd else self.coef_fwd
        return float(coef[0] + coef[1:] @ f)

    def to_json(self) -> Dict[str, Any]:
        return dict(
            coef_fwd=[round(float(v), 8) for v in self.coef_fwd],
            coef_bwd=[round(float(v), 8) for v in self.coef_bwd],
            fmin=[round(float(v), 6) for v in self.fmin],
            fmax=[round(float(v), 6) for v in self.fmax],
            n_train=self.n_train, n_test=self.n_test,
            err_fwd=round(self.err_fwd, 6), err_bwd=round(self.err_bwd, 6),
            err_factor=round(self.err_factor, 4),
        )

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "ClassModel":
        return cls(j["coef_fwd"], j["coef_bwd"], j["fmin"], j["fmax"],
                   j.get("n_train", 0), j.get("n_test", 0),
                   j.get("err_fwd", 0.0), j.get("err_bwd", 0.0))


class CostModel:
    """The trained table: per-op-class regressions and their provenance."""

    def __init__(self, classes: Dict[str, ClassModel],
                 platform: str = "unknown",
                 corpus_rows: int = 0,
                 hull_margin: float = HULL_MARGIN):
        self.classes = classes
        self.platform = platform
        self.corpus_rows = int(corpus_rows)
        self.hull_margin = float(hull_margin)

    # ---- training ---------------------------------------------------------

    @classmethod
    def train(cls, corpus: Dict[str, Any], min_rows: int = MIN_CLASS_ROWS,
              test_frac: float = 0.25, lam: float = RIDGE_LAMBDA,
              platform: Optional[str] = None) -> "CostModel":
        """Train on one platform's rows: the majority platform of the
        corpus, or ``platform``; the other rows are dropped, not blended
        into the regression."""
        all_rows = list(corpus.get("rows") or [])
        platforms: Dict[str, int] = {}
        for r in all_rows:
            p = r.get("platform") or "unknown"
            platforms[p] = platforms.get(p, 0) + 1
        if platform is None:
            platform = max(platforms, key=platforms.get) if platforms \
                else "unknown"
        rows = [r for r in all_rows
                if (r.get("platform") or "unknown") == platform]
        by_class: Dict[str, List[Dict[str, Any]]] = {}
        for r in rows:
            by_class.setdefault(row_class(r), []).append(r)
        classes: Dict[str, ClassModel] = {}
        for cname, crows in sorted(by_class.items()):
            if len(crows) < min_rows:
                continue
            X = np.stack([featurize(r) for r in crows])
            div = np.array([max(1.0, float(r.get("work_div") or 1.0))
                            for r in crows])
            mfwd = np.array([float(r["measured"]["fwd_s"]) for r in crows])
            mbwd = np.array([float(r["measured"].get("bwd_s")
                                   or 2.0 * r["measured"]["fwd_s"])
                             for r in crows])
            yf = np.log(np.maximum(mfwd / div, _T_FLOOR))
            yb = np.log(np.maximum(mbwd / div, _T_FLOOR))
            test = _split_test(crows, test_frac)
            train = ~test
            coef_f = _ridge(X[train], yf[train], lam)
            coef_b = _ridge(X[train], yb[train], lam)
            # held-out error; with no test rows, the train error (n_test
            # 0 says which)
            ef = _err(coef_f, X[test], yf[test]) if test.any() \
                else _err(coef_f, X[train], yf[train])
            eb = _err(coef_b, X[test], yb[test]) if test.any() \
                else _err(coef_b, X[train], yb[train])
            classes[cname] = ClassModel(
                coef_f, coef_b,
                X[train].min(axis=0), X[train].max(axis=0),
                int(train.sum()), int(test.sum()), ef, eb)
        return cls(classes, platform=platform, corpus_rows=len(rows))

    # ---- inference --------------------------------------------------------

    def predict(self, row: Dict[str, Any], bwd: bool = False
                ) -> Tuple[Optional[float], float]:
        """(seconds, confidence) for one corpus-row-shaped query: the
        predicted per-device compute time (already divided by the row's
        work_div), None when the class has no regression. Confidence is
        coverage x hull term: outside the hull it decays toward 0."""
        cm = self.classes.get(row_class(row)) \
            or self.classes.get(row.get("type"))
        if cm is None:
            return None, 0.0
        f = featurize(row)
        t = max(math.exp(cm.predict_log(f, bwd=bwd)), _T_FLOOR)
        cov = min(1.0, cm.n_train / 16.0)
        v = cm.hull_violation(f)
        conf = cov * math.exp(-v / max(self.hull_margin, 1e-6))
        return t, float(conf)

    def in_hull(self, row: Dict[str, Any]) -> bool:
        cm = self.classes.get(row_class(row)) \
            or self.classes.get(row.get("type"))
        if cm is None:
            return False
        f = featurize(row)
        return bool(np.all(f >= cm.fmin - self.hull_margin)
                    and np.all(f <= cm.fmax + self.hull_margin))

    # ---- serialization ----------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return dict(
            schema_version=MODEL_SCHEMA_VERSION,
            corpus_schema=CORPUS_SCHEMA_VERSION,
            platform=self.platform,
            feature_names=list(FEATURE_NAMES),
            hull_margin=self.hull_margin,
            corpus_rows=self.corpus_rows,
            classes={k: v.to_json() for k, v in sorted(self.classes.items())},
        )

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "CostModel":
        ver = int(j.get("schema_version", 0))
        if ver > MODEL_SCHEMA_VERSION:
            raise ValueError(
                f"cost model schema v{ver} is newer than this build "
                f"understands (<= v{MODEL_SCHEMA_VERSION})")
        return cls({k: ClassModel.from_json(v)
                    for k, v in (j.get("classes") or {}).items()},
                   platform=j.get("platform", "unknown"),
                   corpus_rows=j.get("corpus_rows", 0),
                   hull_margin=j.get("hull_margin", HULL_MARGIN))

    def save(self, path: str) -> None:
        from flexflow_tpu_torch.obs.artifacts import atomic_write_text
        atomic_write_text(path, json.dumps(self.to_json(), indent=1))

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # ---- native export ----------------------------------------------------

    def native_table(self) -> Dict[str, Any]:
        """The coefficient table ``machine_to_json`` embeds for the
        native evaluator (ffs_machine.hpp ``LearnedCostModel``): only
        classes that met the coverage gate exist here, so a class absent
        from the table is priced analytically."""
        return dict(
            feature_count=len(FEATURE_NAMES),
            hull_margin=self.hull_margin,
            classes={
                k: dict(wf=[float(v) for v in cm.coef_fwd],
                        wb=[float(v) for v in cm.coef_bwd],
                        fmin=[float(v) for v in cm.fmin],
                        fmax=[float(v) for v in cm.fmax],
                        n=cm.n_train, err=cm.err_fwd)
                for k, cm in sorted(self.classes.items())},
        )


def train_model(corpus: Dict[str, Any], **kw) -> CostModel:
    return CostModel.train(corpus, **kw)


def repo_root() -> str:
    """The checkout's root, where the default model, corpus and
    calibration files live."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_model_path() -> str:
    """``FFS_COSTMODEL_FILE``, else the repo root's ``COSTMODEL_GPU.json``
    (where ``python -m flexflow_tpu_torch.scripts.costmodel train``
    writes)."""
    return (os.environ.get("FFS_COSTMODEL_FILE")
            or os.path.join(repo_root(), DEFAULT_MODEL_FILE))


def load_model(path: Optional[str] = None) -> Optional[CostModel]:
    """The trained model at ``path`` (default discovery), or None when
    absent or unreadable. A model of a newer schema raises."""
    path = path or default_model_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return CostModel.from_json(data)


def load_native_table(path: Optional[str] = None,
                      platform: Optional[str] = None,
                      device=None) -> Optional[Dict[str, Any]]:
    """The native coefficient table for a search on ``device``, or None.

    ``platform`` defaults to the platform of ``device``
    (``device_identity``: "gpu" for a CUDA device, "cpu" for the CPU,
    "unknown" for None). None when ``FFS_NO_LEARNED_COSTS`` is set, no
    model exists at the discovery path, the model covers no class, or it
    was trained on another platform than the search's (a model of
    platform "unknown" prices any)."""
    if os.environ.get("FFS_NO_LEARNED_COSTS"):
        return None
    model = load_model(path)
    if model is None or not model.classes:
        return None
    if platform is None:
        from flexflow_tpu_torch.obs.artifacts import device_identity
        platform = device_identity(device)[0]
    if model.platform != "unknown" and model.platform != platform:
        return None
    return model.native_table()
