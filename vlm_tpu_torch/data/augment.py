"""Host-side PIL image augmentation: the port's own copy of
``vlm_tpu/data/augment.py``, held equal to it by
``tests/test_torch_shared_layers.py``.

The reference's torchvision training pipeline
(`reference/probing/train/singletask_trainer.py:77-84`): random
horizontal flip, color jitter (brightness/contrast/saturation 0.2), random
rotation ±10°, random affine (±10°, translate 5%, scale 0.9–1.1), on PIL
with randomness from an explicit ``random.Random``, so augmentation is
seedable end to end.
"""

from __future__ import annotations

import math
import random
from typing import Callable, List, Optional

from PIL import Image, ImageEnhance, ImageOps


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, img):
        if self.rng.random() < self.p:
            return ImageOps.mirror(img)
        return img


class ColorJitter:
    def __init__(self, brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2,
                 rng: Optional[random.Random] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = rng or random

    def _factor(self, amount: float) -> float:
        return 1.0 + self.rng.uniform(-amount, amount)

    def __call__(self, img):
        ops = [
            (ImageEnhance.Brightness, self.brightness),
            (ImageEnhance.Contrast, self.contrast),
            (ImageEnhance.Color, self.saturation),
        ]
        self.rng.shuffle(ops)
        for enhancer, amount in ops:
            if amount > 0:
                img = enhancer(img).enhance(self._factor(amount))
        return img


class RandomRotation:
    def __init__(self, degrees: float = 10.0,
                 rng: Optional[random.Random] = None):
        self.degrees = degrees
        self.rng = rng or random

    def __call__(self, img):
        angle = self.rng.uniform(-self.degrees, self.degrees)
        return img.rotate(angle, resample=Image.BILINEAR)


class RandomAffine:
    def __init__(self, degrees: float = 10.0, translate=(0.05, 0.05),
                 scale=(0.9, 1.1), rng: Optional[random.Random] = None):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.rng = rng or random

    def __call__(self, img):
        angle = math.radians(self.rng.uniform(-self.degrees, self.degrees))
        s = self.rng.uniform(*self.scale)
        tx = self.rng.uniform(-self.translate[0],
                              self.translate[0]) * img.width
        ty = self.rng.uniform(-self.translate[1],
                              self.translate[1]) * img.height
        cos_a, sin_a = math.cos(angle) / s, math.sin(angle) / s
        cx, cy = img.width / 2, img.height / 2
        # Inverse affine about the center, then the translation.
        a, b = cos_a, sin_a
        c = cx - a * cx - b * cy - tx
        d, e = -sin_a, cos_a
        f = cy - d * cx - e * cy - ty
        return img.transform(img.size, Image.AFFINE, (a, b, c, d, e, f),
                             resample=Image.BILINEAR)


def train_augmentation(seed: Optional[int] = None) -> Compose:
    """The reference training augmentation pipeline, seedable."""
    rng = random.Random(seed) if seed is not None else random.Random()
    return Compose([
        RandomHorizontalFlip(rng=rng),
        ColorJitter(0.2, 0.2, 0.2, rng=rng),
        RandomRotation(10.0, rng=rng),
        RandomAffine(10.0, (0.05, 0.05), (0.9, 1.1), rng=rng),
    ])
