"""Roofline terms of a traced step on one H100: the port of the JAX
package's ``launch/roofline.py``.

Three terms a cell, in seconds:

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = collective bytes / NVLINK_BW

from ``launch.op_analysis`` counts (the JAX package's come from its HLO
analysis).  One card has no collectives, so the third term is 0.  The
JAX package's ``roofline_terms`` and ``collective_bytes`` read
``cost_analysis()`` and XLA HLO text; the port produces neither and has
no counterpart for them.
"""

from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def roofline_terms_from_analysis(ana: dict, model_flops: float,
                                 chips: int) -> dict:
    """ana: ``OpAnalysis.result()`` (or ``hlo_analysis.analyze_text``'s
    keys)."""
    return _terms(float(ana["flops"]), float(ana["bytes"]),
                  float(ana["collective_total"]), model_flops, chips)


def _terms(flops_dev: float, bytes_dev: float, coll_dev: float,
           model_flops: float, chips: int) -> dict:
    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    useful = model_flops / chips / PEAK_FLOPS_BF16 if model_flops else 0.0
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "model_flops_global": model_flops,
        # how much of the counted compute is useful (catches remat waste)
        "model_to_hlo_flops": (model_flops / (flops_dev * chips)
                               if flops_dev else 0.0),
        # fraction of roofline if the dominant term were perfectly achieved
        "roofline_fraction": (useful / bound) if bound > 0 else 0.0,
    }


def model_flops_train(cfg, seq_len: int, global_batch: int) -> float:
    """6 * N(_active) * D for a train step."""
    n = cfg.active_params_count()
    return 6.0 * n * seq_len * global_batch


def model_flops_prefill(cfg, seq_len: int, global_batch: int) -> float:
    return 2.0 * cfg.active_params_count() * seq_len * global_batch


def model_flops_decode(cfg, global_batch: int) -> float:
    """One token per sequence."""
    return 2.0 * cfg.active_params_count() * global_batch
