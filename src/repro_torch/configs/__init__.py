from repro_torch.configs.base import (DraftConfig, InputShape, INPUT_SHAPES,
                                      MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig, get_config, head_preserving,
                                      list_configs, register, tree_for)
