"""Two-deck YAML configuration: flatten, merge, unflatten, forward ranges.

Same semantics as ``tsadar_tpu.utils.config``: ``defaults.yaml`` is flattened
to leaf paths, updated with the flattened ``inputs.yaml`` (inputs win at leaf
granularity) and unflattened back.
"""


def flatten(d, prefix=()):
    out = {}
    for k, v in d.items():
        key = prefix + (k,)
        if isinstance(v, dict) and v:
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat):
    out = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


def merge_configs(defaults, inputs):
    flat = flatten(defaults)
    flat.update(flatten(inputs))
    return unflatten(flat)


def set_forward_ranges(config):
    """Derive lamrangE/lamrangI/npts from the deck's forward ranges and CCD size."""
    fit_rng = config["data"]["fit_rng"]
    config["other"]["lamrangE"] = [fit_rng["forward_epw_start"], fit_rng["forward_epw_end"]]
    config["other"]["lamrangI"] = [fit_rng["forward_iaw_start"], fit_rng["forward_iaw_end"]]
    config["other"]["npts"] = int(config["other"]["CCDsize"][1] * config["other"]["points_per_pixel"])
    return config
