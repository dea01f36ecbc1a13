"""Write the synthetic a1 mocap clip used by the tests and chip_smoke.py.

    python tests/make_a1_synth_clip.py [--seed 0] [--out PATH]

The clip is an AMP JSON file (the 85-column frame layout read by
``data/amp_loader.py``: pos[0:3], orn[3:7] quat xyzw, jang[7:19],
vel[31:34], avel[34:37], jvel[37:49], kp[61:73], kp_vel[73:85]) in bullet
(z-up) coordinates, 48 frames at 60 Hz (FrameDuration 1/60, i.e. 33
simulator substeps of 5e-4 s per frame). The motion is the a1 rest pose
(calf joints at -0.8 rad, tests/fixtures/a1/urdf/a1.urdf) plus a small
trotting oscillation of every joint whose amplitudes and phase jitter are
drawn from ``--seed``, on a root that walks forward at 0.4 m/s with a
little bob and yaw sway. Velocities are the analytic derivatives of the
positions, so the clip is self-consistent.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

N_FRAMES = 48
FPS = 60.0
GAIT_HZ = 2.0
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "fixtures", "motion_sequences", "a1-synth", "amp-a1-synth.txt",
)


def make_frames(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(N_FRAMES) / FPS
    w = 2.0 * np.pi * GAIT_HZ
    frames = np.zeros((N_FRAMES, 85))

    # root: forward walk along bullet x, bob in z, small yaw sway
    height, speed = 0.30, 0.4
    bob, yaw_amp = 0.008, 0.05
    frames[:, 0] = speed * t
    frames[:, 2] = height + bob * np.sin(2 * w * t)
    yaw = yaw_amp * np.sin(w * t)
    frames[:, 3:7] = np.stack(
        [np.zeros_like(t), np.zeros_like(t), np.sin(yaw / 2), np.cos(yaw / 2)], -1
    )
    frames[:, 31] = speed
    frames[:, 33] = 2 * w * bob * np.cos(2 * w * t)
    frames[:, 36] = w * yaw_amp * np.cos(w * t)

    # joints: rest pose + trot (FR/RL in phase, FL/RR half a cycle later)
    rest = np.zeros(12)
    rest[[2, 5, 8, 11]] = -0.8
    leg_phase = np.repeat([0.0, np.pi, np.pi, 0.0], 3)  # FR FL RR RL
    amp = np.tile([0.05, 0.15, 0.2], 4) * rng.uniform(0.8, 1.2, 12)
    phase = leg_phase + rng.uniform(-0.2, 0.2, 12)
    frames[:, 7:19] = rest + amp * np.sin(w * t[:, None] + phase)
    frames[:, 37:49] = amp * w * np.cos(w * t[:, None] + phase)
    return frames


def write_clip(path: str = DEFAULT_OUT, seed: int = 0) -> str:
    frames = make_frames(seed)
    head = {
        "LoopMode": "Wrap",
        "FrameDuration": 1.0 / FPS,
        "EnableCycleOffsetPosition": True,
        "EnableCycleOffsetRotation": True,
    }
    rows = [json.dumps([round(float(x), 6) for x in row]) for row in frames]
    text = json.dumps(head)[:-1] + ', "Frames": [\n' + ",\n".join(rows) + "\n]}\n"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    print(write_clip(args.out, args.seed))
