"""Terminal joypad — the cmw-FakeJoypad analog (reference R4-R6).

The reference renders an SDL window and maps WASD + arrow keys to two
virtual analog sticks published on YARP (FakeJoypad.cpp:120-183,
JoypadProvider.cpp:32-43). Here: raw-terminal WASD (motion) + QE (facing
yaw) feeding a callback/mailbox; used by `walk --interactive`.

A copy of `cmw_tpu/apps/joypad.py` (no array library in it) for the
PyTorch package, which may not import the JAX one.

Keys: w/s forward/back, a/d left/right, q/e face left/right,
      space stop, x quit.
"""

from __future__ import annotations

import math
import select
import sys
import threading


class TerminalJoypad:
    def __init__(self, on_change):
        """on_change(motion_x, motion_y, facing_x, facing_y)"""
        self.on_change = on_change
        self.motion = [0.0, 0.0]
        self.yaw = 0.0
        self._stop = threading.Event()
        self._thread = None

    def _publish(self):
        self.on_change(
            self.motion[0], self.motion[1], math.cos(self.yaw), math.sin(self.yaw)
        )

    def handle_key(self, ch: str) -> bool:
        """Returns False when the user quits."""
        step = 0.25
        if ch == "w":
            self.motion[0] = min(1.0, self.motion[0] + step)
        elif ch == "s":
            self.motion[0] = max(-1.0, self.motion[0] - step)
        elif ch == "a":
            self.motion[1] = min(1.0, self.motion[1] + step)
        elif ch == "d":
            self.motion[1] = max(-1.0, self.motion[1] - step)
        elif ch == "q":
            self.yaw = min(0.5, self.yaw + 0.1)
        elif ch == "e":
            self.yaw = max(-0.5, self.yaw - 0.1)
        elif ch == " ":
            self.motion = [0.0, 0.0]
            self.yaw = 0.0
        elif ch == "x":
            return False
        self._publish()
        return True

    def _loop(self):
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._stop.is_set():
                r, _, _ = select.select([sys.stdin], [], [], 0.1)
                if r:
                    ch = sys.stdin.read(1)
                    if not self.handle_key(ch):
                        break
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
