"""Experiment entry point (port of srgan_st_tpu/main.py).

Experiments are functions that mutate a Config by a job index (read from
the `job_index` environment variable unless given, so array jobs of any
scheduler map onto it; reference main.py:27-47), then train and test:

    python -m srgan_st_tpu_torch run --job_index 1 [--set GROUP.FIELD=VALUE] [--device cpu]

Every job runs. Jobs 0 and 2 (ContentVGG) read the VGG19 weights at
MODEL.G_LOSS.VGG19_WEIGHTS, an npz in tools/convert_vgg19.py's format
(HWIO kernels under torchvision's `features.{i}.weight` / `.bias` keys).
"""

from __future__ import annotations

from srgan_st_tpu_torch.core.config import Config, apply_overrides, get_jobindex


def warmup_gan(config: Config, epochs: int = 5) -> Config:
    """Warm up the generator / train SRResNet (reference main.py:33-38)."""
    config.EXP.N_EPOCHS = epochs
    config.EXP.NAME = f"resnet{epochs}"
    config.G_CHECKPOINT_INTERVAL = 5
    return config


# The loss-comparison sweep the reference was built for: Patchwise-ST vs ST,
# each with VGG or D content loss, and a pixel baseline.
VARIANTS = [
    ("patchwise-st-vgg", "PatchwiseST", "ContentVGG"),
    ("patchwise-st-disc", "PatchwiseST", "ContentDiscriminator"),
    ("st-vgg", "ST", "ContentVGG"),
    ("st-disc", "ST", "ContentDiscriminator"),
    ("pixel-baseline", "Pixel", None),
]


def st_experiment(config: Config, i: int) -> Config:
    name, main_loss, content = VARIANTS[i % len(VARIANTS)]
    config.EXP.NAME = name
    kind = {"PatchwiseST": "patchwise_st", "ST": "st", "Pixel": "pixel"}[main_loss]
    config.add_g_criterion(main_loss, {"kind": kind},
                           config.MODEL.G_LOSS.CRITERION_WEIGHTS[main_loss])
    if content == "ContentVGG":
        config.add_g_criterion("ContentVGG", {"kind": "content_vgg"}, 1.0)
    elif content == "ContentDiscriminator":
        config.add_g_criterion("ContentDiscriminator", {"kind": "content_disc"}, 2000.0)
    return config


def main(argv=None) -> None:
    import argparse

    from srgan_st_tpu_torch.eval.validate import test
    from srgan_st_tpu_torch.parallel.distributed import is_coordinator
    from srgan_st_tpu_torch.train.train import train

    parser = argparse.ArgumentParser(
        description="Run one experiment of the ST-comparison sweep, selected "
        "by job index (array-job compatible): 0 PatchwiseST + ContentVGG, "
        "1 PatchwiseST + ContentDiscriminator, 2 ST + ContentVGG, "
        "3 ST + ContentDiscriminator, 4 the pixel baseline. The ContentVGG "
        "jobs read MODEL.G_LOSS.VGG19_WEIGHTS (tools/convert_vgg19.py's npz).")
    parser.add_argument("--job_index", type=int, default=None,
                        help="experiment index; default: the job_index "
                        "environment variable set by the scheduler")
    parser.add_argument("--set", action="append", default=[],
                        metavar="GROUP.FIELD=VALUE",
                        help="override any config field (repeatable), applied "
                        "after the job-index experiment mutator")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    job_index = get_jobindex() if args.job_index is None else args.job_index
    print(f"Running job: {job_index}")
    config = apply_overrides(st_experiment(Config(), job_index), args.set)
    train(config, args.device)
    if is_coordinator():  # the test set is scored once, by process 0
        test(config, save_images=True, device=args.device)
    print(f"Finished job: {job_index}")


if __name__ == "__main__":
    main()
