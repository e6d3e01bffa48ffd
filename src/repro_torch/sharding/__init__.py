from repro_torch.sharding.rules import (P, PartitionSpec, batch_spec,
                                        cache_specs, param_specs,
                                        prepend_axis)

__all__ = ["P", "PartitionSpec", "param_specs", "batch_spec", "cache_specs",
           "prepend_axis"]
