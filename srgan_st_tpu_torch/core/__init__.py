from srgan_st_tpu_torch.core.config import Config, dotdict  # noqa: F401
