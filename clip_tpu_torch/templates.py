"""Prompt-template ensembling for zero-shot classification.

The reference scores raw class names only and documents the resulting
accuracy gap vs open_clip (upstream tests/README.md:12-20: "no prompt
template averaging").  This module closes that gap as an *opt-in*: the
default protocol everywhere stays raw-class-name for reference parity.

``OPENAI_IMAGENET_TEMPLATES`` is the 80-prompt ensemble from the CLIP paper
(Radford et al. 2021, public); ``BASIC_TEMPLATES`` is the cheap 7-prompt
subset commonly used when encoding cost matters.  Ensembling follows the
standard recipe: encode every (template, class) prompt, L2-normalize,
average per class, re-normalize.
"""

from __future__ import annotations

BASIC_TEMPLATES = (
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
)

OPENAI_IMAGENET_TEMPLATES = (
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a sculpture of a {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of the {}.",
    "a rendering of a {}.",
    "graffiti of a {}.",
    "a bad photo of the {}.",
    "a cropped photo of the {}.",
    "a tattoo of a {}.",
    "the embroidered {}.",
    "a photo of a hard to see {}.",
    "a bright photo of a {}.",
    "a photo of a clean {}.",
    "a photo of a dirty {}.",
    "a dark photo of the {}.",
    "a drawing of a {}.",
    "a photo of my {}.",
    "the plastic {}.",
    "a photo of the cool {}.",
    "a close-up photo of a {}.",
    "a black and white photo of the {}.",
    "a painting of the {}.",
    "a painting of a {}.",
    "a pixelated photo of the {}.",
    "a sculpture of the {}.",
    "a bright photo of the {}.",
    "a cropped photo of a {}.",
    "a plastic {}.",
    "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.",
    "a photo of the {}.",
    "a good photo of the {}.",
    "a rendering of the {}.",
    "a {} in a video game.",
    "a photo of one {}.",
    "a doodle of a {}.",
    "a close-up photo of the {}.",
    "a photo of a {}.",
    "the origami {}.",
    "the {} in a video game.",
    "a sketch of a {}.",
    "a doodle of the {}.",
    "a origami {}.",
    "a low resolution photo of a {}.",
    "the toy {}.",
    "a rendition of the {}.",
    "a photo of the clean {}.",
    "a photo of a large {}.",
    "a rendition of a {}.",
    "a photo of a nice {}.",
    "a photo of a weird {}.",
    "a blurry photo of a {}.",
    "a cartoon {}.",
    "art of a {}.",
    "a sketch of the {}.",
    "a embroidered {}.",
    "a pixelated photo of a {}.",
    "itap of the {}.",
    "a jpeg corrupted photo of the {}.",
    "a good photo of a {}.",
    "a plushie {}.",
    "a photo of the nice {}.",
    "a photo of the small {}.",
    "a photo of the weird {}.",
    "the cartoon {}.",
    "art of the {}.",
    "a drawing of the {}.",
    "a photo of the large {}.",
    "a black and white photo of a {}.",
    "the plushie {}.",
    "a dark photo of a {}.",
    "itap of a {}.",
    "graffiti of the {}.",
    "a toy {}.",
    "itap of my {}.",
    "a photo of a cool {}.",
    "a photo of a small {}.",
    "a tattoo of the {}.",
)

TEMPLATE_SETS = {
    "none": None,
    "basic": BASIC_TEMPLATES,
    "openai": OPENAI_IMAGENET_TEMPLATES,
}


def resolve_templates(spec):
    """``spec``: None/'none' (reference parity), a named set ('basic',
    'openai'), a single template string containing '{}', or a sequence of
    such strings.  Returns None or a tuple of templates."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec in TEMPLATE_SETS:
            return TEMPLATE_SETS[spec]
        if "{}" not in spec:
            raise ValueError(
                f"template {spec!r} must contain '{{}}' or be one of "
                f"{sorted(TEMPLATE_SETS)}")
        return (spec,)
    out = tuple(spec)
    for t in out:
        if "{}" not in t:
            raise ValueError(f"template {t!r} must contain '{{}}'")
    return out or None
