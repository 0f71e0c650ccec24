from repro_torch.configs.base import (DraftConfig, InputShape, INPUT_SHAPES,
                                      MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig, get_config, list_configs,
                                      register, tree_for)
