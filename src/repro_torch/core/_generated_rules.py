"""AUTO-GENERATED by repro_torch.core.codegen — do not edit.

Data-aware kernel-config rules of the port's Hopper kernels (M_b: rows a
run of the gather and segment_reduce; S_b: segments a tile of the fused
transform-reduce), distilled from the analytical H100 cost model
(repro_torch.core.costmodel) over the augmented Table II datasets.
Features: log2_idx_size, log2_avg, log2_feat.
Regenerate with ``python -m repro_torch.core.train_rules``.
"""
from repro_torch.core.config_space import KernelConfig, rule_config


def select_sr(log2_idx_size: float, log2_avg: float, log2_feat: float) -> KernelConfig:
    if log2_avg <= 3.004762499334263:
        if log2_feat <= 6.5:
            if log2_idx_size <= 17.281893679035804:
                if log2_avg <= 1.7318817314397346:
                    if log2_feat <= 4.5:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(64, 64, log2_feat)
                else:
                    if log2_idx_size <= 16.529499183021784:
                        return rule_config(32, 64, log2_feat)
                    else:
                        return rule_config(64, 64, log2_feat)
            else:
                if log2_idx_size <= 17.491578913861993:
                    if log2_avg <= 2.7898066697406367:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(64, 64, log2_feat)
                else:
                    return rule_config(64, 64, log2_feat)
        else:
            if log2_idx_size <= 16.12617003866545:
                if log2_idx_size <= 14.533203109878396:
                    if log2_idx_size <= 11.359200380607607:
                        return rule_config(32, 64, log2_feat)
                    else:
                        return rule_config(64, 64, log2_feat)
                else:
                    if log2_avg <= 2.2506483070020877:
                        return rule_config(128, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
            else:
                if log2_avg <= 2.859426921912788:
                    if log2_idx_size <= 16.285430161940013:
                        return rule_config(128, 64, log2_feat)
                    else:
                        return rule_config(128, 64, log2_feat)
                else:
                    return rule_config(32, 64, log2_feat)
    else:
        if log2_idx_size <= 20.070386051337806:
            if log2_avg <= 4.0069591182875985:
                if log2_idx_size <= 17.997179043142154:
                    if log2_idx_size <= 17.550709311341524:
                        return rule_config(32, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
                else:
                    if log2_feat <= 6.5:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
            else:
                if log2_idx_size <= 19.692515375388023:
                    if log2_idx_size <= 19.479643780029885:
                        return rule_config(32, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
                else:
                    if log2_avg <= 5.110094628196352:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
        else:
            if log2_feat <= 6.5:
                if log2_idx_size <= 21.285412850887823:
                    if log2_avg <= 6.085814404924175:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(32, 64, log2_feat)
                else:
                    if log2_avg <= 7.0698983543631595:
                        return rule_config(64, 64, log2_feat)
                    else:
                        return rule_config(64, 64, log2_feat)
            else:
                return rule_config(32, 64, log2_feat)


def select(log2_idx_size: float, log2_avg: float, log2_feat: float) -> KernelConfig:
    return select_sr(log2_idx_size, log2_avg, log2_feat)
