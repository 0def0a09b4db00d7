"""Checkpoint / resume for fitted Picard models.

The reference has no persistence at all (SURVEY.md §5 — its nearest
analog is re-seeding a run through ``w_init``). Here a fitted
:class:`~picard_ica_tpu.results.PicardResult` round-trips through a
single ``.npz`` file, and :func:`resume_config` turns a saved result
into the warm start for a continued run (e.g. fitting further on new
data from the same sources, or tightening the tolerance):

    result = Picard.fit(x, config)
    save_result("fit.npz", result)
    ...
    prev = load_result("fit.npz")
    cfg2 = resume_config(prev, config.replace(tol=1e-6))
    result2 = Picard.fit(x, cfg2)   # starts at the previous solution

Arrays are stored as NumPy (host) arrays; loading returns NumPy arrays
that any subsequent ``fit``/``transform`` call moves back onto the
device mesh as needed.
"""

from __future__ import annotations

import numpy as np

from .config import PicardConfig
from .results import PicardResult

# Version 2 (round 5): the observability extensions (stage_exits,
# stage_precisions, ls_calls, stage_ls_calls) round-trip too — the
# result IS the observability surface (result.rs:7-33), so a loaded
# checkpoint must not silently lose diagnostics.
# Version-1 files still load (their diagnostic fields come back None,
# exactly what they stored).
_FORMAT_VERSION = 2


def save_result(path, result: PicardResult, include_sources: bool = True) -> None:
    """Serialize a fit result to ``path`` (.npz).

    ``include_sources=False`` drops the (n_components, n_samples)
    sources matrix — for large T the unmixing matrices are what a
    resume needs and the sources can be recomputed with ``transform``.
    """
    payload = {
        "format_version": np.asarray(_FORMAT_VERSION),
        "unmixing": np.asarray(result.unmixing),
        "n_iterations": np.asarray(result.n_iterations),
        "converged": np.asarray(result.converged),
        "gradient_norm": np.asarray(result.gradient_norm),
    }
    if include_sources:
        payload["sources"] = np.asarray(result.sources)
    if result.whitening is not None:
        payload["whitening"] = np.asarray(result.whitening)
    if result.mean is not None:
        payload["mean"] = np.asarray(result.mean)
    if result.signs is not None:
        payload["signs"] = np.asarray(result.signs)
    # Observability extensions (all Optional on the result).
    if result.stage_exits is not None:
        payload["stage_exits"] = np.asarray(result.stage_exits, np.int64)
    if result.stage_precisions is not None:
        # np.savez stores unicode arrays natively; kept as one array so
        # stage alignment with stage_exits survives the round trip.
        payload["stage_precisions"] = np.asarray(result.stage_precisions, np.str_)
    if result.ls_calls is not None:
        payload["ls_calls"] = np.asarray(result.ls_calls, np.int64)
    if result.stage_ls_calls is not None:
        payload["stage_ls_calls"] = np.asarray(result.stage_ls_calls, np.int64)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_result(path) -> PicardResult:
    """Load a result saved by :func:`save_result`."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} is newer than supported "
                f"({_FORMAT_VERSION})"
            )
        return PicardResult(
            whitening=z["whitening"] if "whitening" in z else None,
            unmixing=z["unmixing"],
            sources=z["sources"] if "sources" in z else None,
            mean=z["mean"] if "mean" in z else None,
            n_iterations=int(z["n_iterations"]),
            converged=bool(z["converged"]),
            gradient_norm=float(z["gradient_norm"]),
            signs=z["signs"] if "signs" in z else None,
            stage_exits=(tuple(int(v) for v in z["stage_exits"])
                         if "stage_exits" in z else None),
            stage_precisions=(tuple(str(v) for v in z["stage_precisions"])
                              if "stage_precisions" in z else None),
            ls_calls=int(z["ls_calls"]) if "ls_calls" in z else None,
            stage_ls_calls=(tuple(int(v) for v in z["stage_ls_calls"])
                            if "stage_ls_calls" in z else None),
        )


def resume_config(previous: PicardResult, config: PicardConfig) -> PicardConfig:
    """Derive a config that warm-starts from ``previous``'s solution.

    Sets ``w_init`` to the previous unmixing matrix and clears any
    JADE/FastICA warm start (they would overwrite it). The data passed
    to the resumed ``fit`` must have the same n_components.

    **Whitening-basis caveat.** ``previous.unmixing`` lives in the
    whitening basis of the data it was FITTED on. A resumed fit
    whitens ITS data and applies ``w_init`` in that new basis, so:

    * same data (e.g. tightening ``tol``): the bases are identical and
      the resume continues exactly where the fit stopped;
    * different data drawn from the same sources: the two whitening
      bases agree only up to sampling noise (O(1/sqrt(T)) rotations,
      worse when covariance eigengaps are small), so ``w_init`` is a
      good but inexact warm start — the fit converges to the new
      data's solution, just in fewer iterations than a cold start;
    * unrelated data: the basis composition is meaningless and the
      warm start is no better than random.

    To transfer a model across datasets without refitting, use
    :meth:`~picard_ica_tpu.solver.Picard.transform` (which applies the
    saved ``full_unmixing`` directly) rather than a resumed fit.
    """
    return config.replace(
        w_init=np.asarray(previous.unmixing),
        jade_it=None,
        fastica_it=None,
    )
