"""The probe trainers' training augmentation in plain PIL: the original
torchvision pipeline's random horizontal flip (probability 1/2), colour
jitter (brightness, contrast and saturation each by a factor drawn from
[0.8, 1.2], in an order drawn anew for each image), rotation by up to 10
degrees and an affine map (up to 10 degrees, scale 0.9-1.1, a shift of up
to 5 % of each side), bilinear, with every draw taken from one
``random.Random(seed)`` image after image in the order they are loaded.
The reference decodes the training files itself and replays these draws,
so that it takes no image the program prepared. Nothing here imports the
program."""

from __future__ import annotations

import math
import random

from PIL import Image, ImageEnhance, ImageOps


class Augment:
    """The draws of one training run, image by image."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        r = self.rng
        if r.random() < 0.5:
            img = ImageOps.mirror(img)
        ops = [ImageEnhance.Brightness, ImageEnhance.Contrast,
               ImageEnhance.Color]
        r.shuffle(ops)
        for op in ops:
            img = op(img).enhance(1.0 + r.uniform(-0.2, 0.2))
        img = img.rotate(r.uniform(-10.0, 10.0), resample=Image.BILINEAR)
        angle = math.radians(r.uniform(-10.0, 10.0))
        s = r.uniform(0.9, 1.1)
        tx = r.uniform(-0.05, 0.05) * img.width
        ty = r.uniform(-0.05, 0.05) * img.height
        # PIL maps each output pixel back into the input: the rotation and
        # scale about the centre, inverted, then the shift
        a, b = math.cos(angle) / s, math.sin(angle) / s
        cx, cy = img.width / 2, img.height / 2
        coeffs = (a, b, cx - a * cx - b * cy - tx,
                  -b, a, cy + b * cx - a * cy - ty)
        return img.transform(img.size, Image.AFFINE, coeffs,
                             resample=Image.BILINEAR)
