"""Config-level defaults — the port's copy of ``G_DEFAULTS`` and its
setters from ``paddle_tpu/config/parse_state.py`` (≅ the reference's
config_parser ``g_default_*`` globals).  ``layers/api.py`` reads the
default decay and momentum of every parameter from here; both default to
``None``.  ``layers.base.reset_name_counters`` resets them."""

from __future__ import annotations

G_DEFAULTS: dict = {"initial_std": None, "initial_mean": None,
                    "decay_rate": None, "momentum": None,
                    "initial_strategy": None}


def reset_defaults() -> None:
    for k in G_DEFAULTS:
        G_DEFAULTS[k] = None


def default_initial_std(val) -> None:
    G_DEFAULTS["initial_std"] = float(val)


def default_initial_mean(val) -> None:
    G_DEFAULTS["initial_mean"] = float(val)


def default_decay_rate(val) -> None:
    G_DEFAULTS["decay_rate"] = float(val)


def default_momentum(val) -> None:
    """Per-parameter momentum default: flows into ``ParamSpec.momentum``
    and overrides the optimizer's coefficient."""
    G_DEFAULTS["momentum"] = float(val)


def default_initial_strategy(val) -> None:
    G_DEFAULTS["initial_strategy"] = int(val)
