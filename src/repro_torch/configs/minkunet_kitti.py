"""MinkUNet on SemanticKITTI-like scenes (port of
``repro.configs.minkunet_kitti``): width 1.0 / 0.5, plus the small
benchmark variant the CPU tests run."""
from repro_torch.models.minkunet import MinkUNetConfig

CONFIG_1X = MinkUNetConfig(in_channels=4, num_classes=19, width=1.0)
CONFIG_05X = MinkUNetConfig(in_channels=4, num_classes=19, width=0.5)
CONFIG_BENCH = MinkUNetConfig(in_channels=4, num_classes=19, width=0.25,
                              blocks_per_stage=1)
