from .config import (
    CacheConfig,
    ChatTemplate,
    FrameworkConfig,
    ModelConfig,
    ParallelConfig,
    RuntimeConfig,
    ServerConfig,
    PRESETS,
    load_config,
    preset,
)

__all__ = [
    "CacheConfig",
    "ChatTemplate",
    "FrameworkConfig",
    "ModelConfig",
    "ParallelConfig",
    "RuntimeConfig",
    "ServerConfig",
    "PRESETS",
    "load_config",
    "preset",
]
