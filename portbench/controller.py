"""The walking controller on either side: the program's
(`cmw_tpu_torch.runtime.loop.WalkingController`, whose stages replay cached
CUDA graphs on the card) or the plain reference's (its frozen eager copy),
built alike from the configuration file, the plant and the synthetic
weights the benchmark made."""

from __future__ import annotations

import importlib

from portbench import common, presets


class Controller:
    """side: "program" or "reference"; tf32 only for the reference's
    control."""

    def __init__(self, side: str, config: dict, plant: str, weights: dict, device: str, tf32: bool = False):
        root = {"program": "cmw_tpu_torch", "reference": "portbench.reference"}[side]
        self.side, self.tf32 = side, tf32
        self.loop = importlib.import_module(f"{root}.runtime.loop")
        kin = importlib.import_module(f"{root}.core.kinematics")
        net = importlib.import_module(f"{root}.mann.network")
        cfg = presets.walking_config(config, plant, side)
        self.ctl = self.loop.WalkingController(cfg, kin.ergocub_urdf(), net.MANNWeights(**weights), device=device)
        self.cfg = cfg

    def tick_input(self, joypad, ext_force, ext_torque):
        return self.loop.TickInput(joypad, ext_force, ext_torque)

    def initial_state(self, B: int):
        with common.tf32(self.tf32):
            return self.ctl.initial_state(B)

    def warm(self, s, inp) -> None:
        self.ctl.warm_mpc_stage(s, inp)

    def step(self, s, inp, tick: int):
        with common.tf32(self.tf32):
            return self.ctl.step(s, inp, tick)

    def period_fold(self, s, blk, fold, acc):
        """One MPC period through the blocked, folded episode (one replay of
        the period's graph on the card)."""
        with common.tf32(self.tf32):
            return self.ctl.run_episode_fold(s, blk, fold, acc)

    def period_eager(self, s, blk, fold, acc):
        """The same period as the reference computes it: `_period`."""
        with common.tf32(self.tf32):
            return self.ctl._period(s, blk, fold, acc)

    def free(self) -> None:
        """Drop the controller and, on the program's side, every captured
        graph and the graphs' pool."""
        del self.ctl
        if self.side == "program":
            importlib.import_module("cmw_tpu_torch.runtime.cache").clear()
