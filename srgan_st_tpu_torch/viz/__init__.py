"""Figure tools (port of srgan_st_tpu/viz/): comparison crops of several
generators, content-loss feature maps, the best-buddy illustration and
training curves. Nothing imported here imports PIL or matplotlib: they are
imported inside the functions that decode a file or draw a figure, so the
array cores run where neither is installed."""

from srgan_st_tpu_torch.viz.buddy_illustration import buddy_illustration  # noqa: F401
from srgan_st_tpu_torch.viz.save_image_patch import save_image_patch  # noqa: F401
