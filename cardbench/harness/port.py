"""The system under test: the port (``repro_torch``), imported here and
only here, at run time.  It builds the port's ``ModelConfig`` from the
fields the configuration's family file maps (``families/<family>.py``)
and checks that the benchmark's weight layout is the tree the port
expects."""
from __future__ import annotations

import sys

from harness.spec import ROOT, family


def import_port():
    """Put the checkout's ``src`` on the path (the benchmark's command runs
    from the root of a checkout) and import the port."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    return repro_torch


def model_config(config: dict, dtype: str, param_dtype: str):
    """The port's ``ModelConfig`` of the file, as its family maps it (a
    nested group such as ``ssm`` or ``moe`` becomes the port's config of
    that name)."""
    import_port()
    from repro_torch.configs import base

    groups = {"ssm": base.SSMConfig, "moe": base.MoEConfig}
    kw = family(config).port_kwargs(config)
    kw = {k: groups[k](**v) if k in groups and isinstance(v, dict) else v
          for k, v in kw.items()}
    return base.ModelConfig(**kw, dtype=dtype, param_dtype=param_dtype)


def check_layout(cfg, flat: dict) -> None:
    """Raise unless the benchmark's leaves are the port's spec leaf for
    leaf (names and shapes)."""
    from repro_torch.models.spec import model_spec

    want = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}")
        else:
            want[path] = tuple(t.shape)

    walk(model_spec(cfg), "")
    have = {p: tuple(t.shape) for p, t in flat.items()}
    if have != want:
        raise RuntimeError(
            "the benchmark's weight layout is not the port's parameter "
            f"tree: only in the benchmark {sorted(set(have) - set(want))}, "
            f"only in the port {sorted(set(want) - set(have))}, shapes "
            f"differ at {[p for p in have if p in want and have[p] != want[p]]}")
