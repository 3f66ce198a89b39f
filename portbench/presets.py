"""A configuration file as the program's and as the reference's
`WalkingConfig`, each checked against the sizes the file states."""

from __future__ import annotations

import importlib


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def walking_config(config: dict, plant: str, side: str):
    """The configuration's preset on the program's side ("program": the
    package `cmw_tpu_torch`) or the reference's ("reference"), on the
    kinematic or the rigid-body plant. ValueError where a size differs from
    the file's: the file states the configuration as it is run."""
    root = {"program": "cmw_tpu_torch", "reference": "portbench.reference"}[side]
    presets = importlib.import_module(f"{root}.runtime.config")
    overrides = {}
    if plant == "rigid":
        overrides["rigid"] = importlib.import_module(f"{root}.sim.rigid_body").RigidBodyConfig()
    elif plant != "kinematic":
        raise ValueError(f"plant {plant!r}: expected kinematic or rigid")
    cfg = getattr(presets, config["preset"])(**overrides)
    for path, want in config["sizes"].items():
        got = _get(cfg, path)
        if got != want and not (isinstance(want, float) and abs(got - want) <= 1e-12 * max(1.0, abs(want))):
            raise ValueError(f"{side} preset {config['preset']}: {path} = {got!r}, the configuration states {want!r}")
    return cfg
