from rbg_tpu_torch.portalloc.allocator import PortAllocator
from rbg_tpu_torch.portalloc.manager import (
    PortAllocatorService, env_name, get_port_allocator, parse_port_config,
    setup_port_allocator,
)

__all__ = [
    "PortAllocator", "PortAllocatorService", "setup_port_allocator",
    "get_port_allocator", "parse_port_config", "env_name",
]
