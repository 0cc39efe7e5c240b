"""train_images_per_s: images finished in the window over its seconds."""

from benchmark.measures import rate as read  # noqa: F401
