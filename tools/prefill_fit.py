#!/usr/bin/env python3
"""Would each arch's ``prefill_32k`` cell fit one H100 at ``data=1``?

The spec `build` sizes a non-reduced engine at `launch.serve.FULL_DIMS`,
where the JAX package's takes the ``prefill_32k`` cell's geometry
(`launch.shapes.serve_cell_dims`), which assumes 16 data replicas.  This
counts the one-card program at that geometry with one replica (the whole
model folded into one stage, `configs.single_stage`; the cell's 32
sequences all in its pools) on the meta device (`launch.dryrun.count_serve`):
the bytes of the weights, the pools and the inputs, the peak of the
temporaries, and whether their sum fits the data sheet's 80 GB.  Nothing
is allocated; it runs on any host.

    PYTHONPATH=src python tools/prefill_fit.py
"""

import json

from repro_torch.configs import ASSIGNED_SHAPES, get_config, list_archs
from repro_torch.configs import single_stage
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import rank_layout
from repro_torch.roofline.analysis import HBM_BYTES


def main() -> None:
    for arch in list_archs():
        cfg = single_stage(get_config(arch))
        dims = shapes.serve_cell_dims(cfg, ASSIGNED_SHAPES["prefill_32k"],
                                      data=1)
        st = dryrun.count_serve(cfg, dims, rank_layout(1, 1, 1), 0)
        other = st["argument_bytes"] - st["param_bytes"]
        print(json.dumps({
            "arch": arch, "pages": dims.pages, "slots": dims.slots,
            "weights_gb": st["param_bytes"] / 1e9,
            "pools_and_inputs_gb": other / 1e9,
            "peak_temporaries_gb": st["peak_live_bytes"] / 1e9,
            "total_gb": st["memory_bytes"] / 1e9,
            "fits_80_gb": st["memory_bytes"] <= HBM_BYTES}))


if __name__ == "__main__":
    main()
