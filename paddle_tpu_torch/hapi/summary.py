"""Model summary (``paddle_tpu/hapi/summary.py``; reference
python/paddle/hapi/model_summary.py): each layer's parameter count and
the totals."""
from __future__ import annotations

def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    rows = []
    total_params = 0
    trainable = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = 0
        for p in layer._parameters.values():
            if p is not None:
                n_params += p.size
                total_params += p.size
                if getattr(p, "trainable", True):
                    trainable += p.size
        if n_params:
            rows.append((name or type(layer).__name__, type(layer).__name__, n_params))
    width = max([len(r[0]) for r in rows], default=20) + 2
    print(f"{'Layer':<{width}}{'Type':<24}{'Params':>12}")
    print("-" * (width + 36))
    for name, tname, n in rows:
        print(f"{name:<{width}}{tname:<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total_params, "trainable_params": trainable}
