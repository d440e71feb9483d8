"""Material classification: the LinearSVC/SGD study (reference
scripts/train.py).

Counterpart of openpbso_tpu/ml/train.py. The reference trains LinearSVC and
SGD classifiers on audio features of simulated impact sounds with
grid-searched C and cross-validation, comparing feature groups
(scripts/train.py:216-251). Here the same study runs in-process on audio
the port's session synthesizes.

sklearn is imported only inside the functions that need it, so that this
module loads where sklearn is not installed; there the study raises a
clear error.

    python -m openpbso_tpu_torch.ml.train [--device cpu] [--out study.json]
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


def _require_sklearn():
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "scikit-learn is required for the material-classification "
            "study") from e


@dataclasses.dataclass
class TrainResult:
    classifier: str
    feature_group: str
    accuracy_mean: float
    accuracy_std: float
    best_c: float | None
    n_samples: int


FEATURE_GROUPS = {
    # index ranges into the 68-dim clip vector (mean[34] + std[34]);
    # mirrors the reference's per-feature-group experiments
    "all": slice(0, 68),
    "time": np.r_[0:3, 34:37],            # zcr/energy/entropy mean+std
    "spectral": np.r_[3:8, 37:42],
    "mfcc": np.r_[8:21, 42:55],
    "chroma": np.r_[21:34, 55:68],
}


def train_linear_svc(x: np.ndarray, y: np.ndarray, *,
                     c_grid=(0.01, 0.1, 1.0, 10.0), cv: int = 4,
                     seed: int = 0):
    _require_sklearn()
    from sklearn.model_selection import GridSearchCV
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import LinearSVC
    pipe = make_pipeline(StandardScaler(), LinearSVC(max_iter=5000))
    grid = GridSearchCV(pipe, {"linearsvc__C": list(c_grid)}, cv=cv)
    grid.fit(x, y)
    return grid


def train_sgd(x: np.ndarray, y: np.ndarray, *, cv: int = 4, seed: int = 0):
    _require_sklearn()
    from sklearn.linear_model import SGDClassifier
    from sklearn.model_selection import cross_val_score
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    pipe = make_pipeline(StandardScaler(),
                         SGDClassifier(random_state=seed, max_iter=2000))
    scores = cross_val_score(pipe, x, y, cv=cv)
    pipe.fit(x, y)
    return pipe, scores


def run_study(x: np.ndarray, y: np.ndarray,
              groups: dict | None = None) -> list[TrainResult]:
    """Grid-searched LinearSVC + SGD over feature groups with CV accuracy,
    mirroring the reference's experiment matrix."""
    _require_sklearn()
    from sklearn.model_selection import cross_val_score
    groups = groups or FEATURE_GROUPS
    results = []
    for gname, sel in groups.items():
        xg = x[:, sel]
        grid = train_linear_svc(xg, y)
        best_c = float(grid.best_params_["linearsvc__C"])
        scores = cross_val_score(grid.best_estimator_, xg, y, cv=4)
        results.append(TrainResult("LinearSVC", gname,
                                   float(scores.mean()), float(scores.std()),
                                   best_c, len(y)))
        _, sgd_scores = train_sgd(xg, y)
        results.append(TrainResult("SGD", gname, float(sgd_scores.mean()),
                                   float(sgd_scores.std()), None, len(y)))
    return results


def main(argv=None) -> int:
    """CLI: synthesize a dataset with the engine and run the study."""
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--objects", type=int, default=3)
    p.add_argument("--hits", type=int, default=3)
    p.add_argument("--modes", type=int, default=32)
    p.add_argument("--seconds", type=float, default=0.4)
    p.add_argument("--out", default="material_study.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the clips are synthesized: the CUDA device "
                        "(the default; raises without one) or the CPU")
    args = p.parse_args(argv)

    from .dataset import features_matrix, synthesize_dataset
    clips = synthesize_dataset(objects_per_material=args.objects,
                               hits_per_object=args.hits,
                               num_modes=args.modes, seconds=args.seconds,
                               device=args.device)
    x, y, labels = features_matrix(clips)
    print(f"dataset: {x.shape[0]} clips x {x.shape[1]} features, "
          f"labels: {labels}")
    results = run_study(x, y)
    for r in results:
        print(f"{r.classifier:10s} {r.feature_group:9s} "
              f"acc={r.accuracy_mean:.3f}+-{r.accuracy_std:.3f}"
              + (f" C={r.best_c}" if r.best_c else ""))
    with open(args.out, "w") as f:
        json.dump([dataclasses.asdict(r) for r in results], f, indent=2)
    return 0


def plot_results_png(results: list[TrainResult], path: str) -> None:
    """Accuracy bar chart PNG (the reference's scripts/plot_bar.py output)
    rendered without matplotlib."""
    from ..apps.render_fields import _write_png
    w, h = 640, 360
    img = np.full((h, w, 3), 250, np.uint8)
    groups = sorted({r.feature_group for r in results})
    classifiers = sorted({r.classifier for r in results})
    colors = {"LinearSVC": (70, 110, 210), "SGD": (220, 130, 60)}
    n = len(groups)
    bar_w = max(8, (w - 80) // (n * (len(classifiers) + 1)))
    base_y = h - 40
    for gi, g in enumerate(groups):
        for ci, c in enumerate(classifiers):
            rs = [r for r in results
                  if r.feature_group == g and r.classifier == c]
            if not rs:
                continue
            acc = rs[0].accuracy_mean
            x0 = 50 + gi * (len(classifiers) + 1) * bar_w + ci * bar_w
            bh = int(acc * (h - 80))
            img[base_y - bh: base_y, x0: x0 + bar_w - 2] = \
                colors.get(c, (120, 120, 120))
    # axis line
    img[base_y: base_y + 2, 40: w - 20] = 30
    img[40: base_y, 48: 50] = 30
    _write_png(path, img)


if __name__ == "__main__":
    raise SystemExit(main())
