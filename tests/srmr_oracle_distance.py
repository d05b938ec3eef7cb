"""How far SRMR in float32 lies from the float64 oracle on ``chip_smoke.py``'s REVERB-shaped utterances.

``chip_smoke.py``'s phase 44 holds the card's SRMR to a float64 scipy oracle
(``lfilter`` for every IIR stage, ``hilbert`` for the envelope) at
``SRMR_RTOL``. This script draws that phase's utterances (8 s at 16 kHz,
``reverb_utterances``) on the CPU for each seed and prints one JSON line a
seed: each utterance's oracle score and the relative distance from it of the
JAX package (eager, on the CPU) and of the port (its CPU path, S1's plain
loop), with and without ``norm``. Not a test: run it from the repository root,

    JAX_PLATFORMS=cpu python tests/srmr_oracle_distance.py --seeds 0 1 --utterances 4

(about a minute a seed and four utterances on one CPU core).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torchmetrics_tpu.functional.audio as JF  # noqa: E402
import torchmetrics_tpu_torch.functional.audio as PF  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--utterances", type=int, default=4)
    args = parser.parse_args()
    cfg = chip_smoke.REVERB
    fs = cfg["fs"]
    for seed in args.seeds:
        gen = torch.Generator().manual_seed(seed)
        wave = chip_smoke.reverb_utterances(torch, "cpu", gen, args.utterances, cfg["samples"], fs).numpy()
        line = {"seed": seed, "utterances": args.utterances, "samples": cfg["samples"], "fs": fs}
        for norm in (False, True):
            oracle = np.asarray(chip_smoke._host_srmr(wave, fs, norm))
            jax_scores = np.asarray(JF.speech_reverberation_modulation_energy_ratio(jnp.asarray(wave), fs, norm=norm))
            port = PF.speech_reverberation_modulation_energy_ratio(torch.from_numpy(wave), fs, norm=norm).numpy()
            line["norm" if norm else "default"] = {
                "oracle": oracle.tolist(),
                "jax_rel": np.abs(jax_scores / oracle - 1).tolist(),
                "port_rel": np.abs(port / oracle - 1).tolist(),
                "port_vs_jax_rel": np.abs(port / jax_scores - 1).tolist(),
            }
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
