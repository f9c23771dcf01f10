"""Chain-level FER waterfall with CFO in the measured loop (round 5).

Sweeps Es/N0 over the coded waterfall for the ONE-LAUNCH seam chain
(eval/coded.measure_chain_fer: demod -> seam frame sync -> Viterbi ->
CRC, acquisition and tracking inside the measured program), in THREE
legs:

- "awgn": pure AWGN (BASELINE config 1 family);
- "cfo": a per-channel carrier-offset SPREAD the tracker must absorb
  (BASELINE config 2 family) -- channel c sees normalized offset
  cfo * (0.25 + 0.75 c/(C-1)) cycles/sample, phase-continuous across
  blocks;
- "acq": a BEYOND-LOCK offset spread (default max 0.02 cycles/sample,
  past the 4th-power tracker's ~0.0156 pull-in) through M-th-power
  acquisition at the operating SNR + the front chain's in-program NCO
  (models/chain.make_front_chain_fn); acquisition failures count as
  frame errors.

Each point also records the union-bound prediction for the decoded
frame: Pb from the K=7 distance spectrum at Eb/N0 = Es/N0 (rate 1/2 x
2 bits/symbol => Eb/N0 == Es/N0 for QPSK), lifted to a frame via
FER_pred = 1 - (1 - Pb)^n_info (an upper-transcription of the bound --
the measured chain should track it through the waterfall and sit near 0
above it).

Writes docs/chain_fer_r05.json.  Runs on the CPU by default so the
artifact is reproducible without a card; pass --gpu to run it there.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--esn0", default="0,1,2,3,4,6,8,10,12")
    ap.add_argument("--cfo", type=float, default=2e-5,
                    help="max normalized CFO (cycles/sample) of the "
                         "per-channel spread in the CFO leg")
    ap.add_argument("--acq-cfo", type=float, default=0.02,
                    help="max normalized CFO of the BEYOND-LOCK spread "
                         "in the acquisition (front-chain) leg")
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default: CPU)")
    ap.add_argument("--out", default=str(ROOT / "docs/chain_fer_r05.json"))
    args = ap.parse_args()

    if not args.gpu:
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.eval.coded import (measure_chain_fer, union_bound)
    from psk_soft_tpu.models.chain import chain_msg_bits
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.fec import CODE_K7, info_bits_for
    from psk_soft_tpu.ops.framesync import FrameFormat

    rng = np.random.default_rng(31)
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    code, crc = CODE_K7, CRC16_CCITT
    n_info = info_bits_for(code, fmt.payload * 2)
    n_msg = chain_msg_bits(fmt, code, crc)
    esn0s = [float(v) for v in args.esn0.split(",")]
    # Three legs: pure AWGN; an in-tracker CFO spread; a BEYOND-LOCK
    # spread through M-th-power acquisition + the front chain's NCO
    # (acquisition errors count as frame errors).
    legs = {"awgn": (0.0, 0.0), "cfo": (args.cfo, 0.0),
            "acq": (0.0, args.acq_cfo)}
    points = []
    for leg, (cfo, fcfo) in legs.items():
        for e in esn0s:
            t0 = time.time()
            p = measure_chain_fer(cfg, fmt, code, crc, e,
                                  channels=args.channels,
                                  blocks=args.blocks, cfo=cfo,
                                  front_cfo=fcfo, seed=3)
            pb = float(union_bound(code, e))      # Eb/N0 == Es/N0 here
            fer_pred = float(1.0 - (1.0 - min(pb, 1.0)) ** n_info)
            rec = {"leg": leg, "cfo": cfo or fcfo, "esn0_db": e,
                   "frames": p.frames, "found": p.found,
                   "crc_ok": p.crc_ok, "msg_exact": p.msg_exact,
                   "overflow": p.overflow, "fer": p.fer,
                   "fer_union_bound": fer_pred,
                   "secs": round(time.time() - t0, 1)}
            points.append(rec)
            print(json.dumps(rec), flush=True)
    out = {
        "config": {"sps": cfg.sps, "num_avg": cfg.num_avg,
                   "phase_avg": cfg.phase_avg, "m": 4,
                   "uw_len": fmt.uw_len, "payload": fmt.payload,
                   "threshold": fmt.threshold, "code": "K7 (171,133)",
                   "crc": "CRC16-CCITT", "n_info": n_info,
                   "n_msg": n_msg, "channels": args.channels,
                   "blocks": args.blocks,
                   "cfo_spread": "f_c = cfo*(0.25+0.75*c/(C-1))"},
        "points": points,
    }
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
