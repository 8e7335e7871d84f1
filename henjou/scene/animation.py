"""TRS keyframe animation (reference: include/renderer/animation.h).

Host-side (numpy): evaluated once per frame to produce instance/camera
affines — exactly the reference's split of animation on CPU, transforms
consumed on device. Binary-search key lookup (animation.h:47-57), linear
interpolation only (STEP/CUBICSPLINE are declared but unimplemented in the
reference too, animation.h:68-79), T*R*S composition (animation.h:81-94).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from henjou.math.affine import (
    compose_affine,
    identity_affine,
    rotate_affine,
    scale_affine,
    translate_affine,
)


@dataclasses.dataclass
class AnimationTrack:
    """One channel (reference AnimationData<T>, animation.h:20-32)."""

    keys: List[float] = dataclasses.field(default_factory=list)
    values: List = dataclasses.field(default_factory=list)
    interpolation: str = "LINEAR"


def _interpolate(track: AnimationTrack, time: float, default):
    """reference: animationInterpolate (animation.h:42-66)."""
    keys = track.keys
    vals = track.values
    if not keys:
        return np.asarray(default, np.float32)
    if len(keys) == 1 or time < 0:
        return np.asarray(vals[0], np.float32)
    # binary search for the last key <= time
    first, length = 0, len(keys)
    while length > 0:
        half = length >> 1
        middle = first + half
        if keys[middle] <= time:
            first = middle + 1
            length -= half + 1
        else:
            length = half
    offset = first - 1
    if offset >= len(keys) - 1:
        return np.asarray(vals[-1], np.float32)
    if offset < 0:
        return np.asarray(vals[0], np.float32)
    t0, t1 = keys[offset], keys[offset + 1]
    delta = (time - t0) / max(t1 - t0, 1e-12)
    a = np.asarray(vals[offset], np.float32)
    b = np.asarray(vals[offset + 1], np.float32)
    # LINEAR for everything (animation.h:68-79 does the same)
    return a * (1.0 - delta) + b * delta


@dataclasses.dataclass
class Animation:
    """reference: struct Animation (animation.h:34-131)."""

    name: str = ""
    translation: AnimationTrack = dataclasses.field(default_factory=AnimationTrack)
    rotation: AnimationTrack = dataclasses.field(default_factory=AnimationTrack)
    scale: AnimationTrack = dataclasses.field(default_factory=AnimationTrack)

    def get_affine(self, time: float) -> np.ndarray:
        """T * R * S (reference getAnimationAffine, animation.h:81-94)."""
        t = _interpolate(self.translation, time, (0.0, 0.0, 0.0))
        r = _interpolate(self.rotation, time, (0.0, 0.0, 0.0, 1.0))
        s = _interpolate(self.scale, time, (1.0, 1.0, 1.0))
        return compose_affine(
            translate_affine(t), compose_affine(rotate_affine(r), scale_affine(s))
        )

    def get_rotation_affine(self, time: float) -> np.ndarray:
        """Rotation-only (camera direction path, animation.h:96-103)."""
        r = _interpolate(self.rotation, time, (0.0, 0.0, 0.0, 1.0))
        return rotate_affine(r)

    def get_translation_affine(self, time: float) -> np.ndarray:
        t = _interpolate(self.translation, time, (0.0, 0.0, 0.0))
        return translate_affine(t)

    def data_check(self) -> bool:
        """Consistency assert (animation.h:112-130)."""
        for name, tr in (
            ("translation", self.translation),
            ("rotation", self.rotation),
            ("scale", self.scale),
        ):
            if len(tr.keys) != len(tr.values):
                import logging

                logging.getLogger("henjou").error(
                    "%s: %s keys/values mismatch", self.name, name
                )
                return False
        return True


def static_animation(translation=(0, 0, 0), rotation=(0, 0, 0, 1), scale=(1, 1, 1)):
    """Base-pose 'animation' with a single key at t=0, the way the glTF
    loader seeds every node (gltfloader.h:1312-1343)."""
    a = Animation()
    a.translation = AnimationTrack(keys=[0.0], values=[list(translation)])
    a.rotation = AnimationTrack(keys=[0.0], values=[list(rotation)])
    a.scale = AnimationTrack(keys=[0.0], values=[list(scale)])
    return a
