"""psk_soft_tpu: a multi-channel PSK soft-demodulation framework in JAX.

Brand-new JAX/XLA/Pallas implementation of the capabilities of the REDHAWK
``rh.psk_soft`` component (reference at /root/reference): streaming M-PSK
demodulation with max-energy symbol-timing recovery, M-th-power carrier-phase
recovery with a sliding linear-fit tracker, optional differential decoding,
and soft-symbol / bit / phase / timing-index outputs -- re-designed as pure
functional block steps that vmap over thousands of channels and shard over
device meshes (one NVIDIA GPU, or the cards of a host).

Layer map (SURVEY.md section 1, array-native mapping):
  runtime/   streaming host runtime (BulkIO/CORBA equivalent)
  config.py, state.py   declarative properties + explicit carry (SCA equivalent)
  models/, ops/         the DSP (psk_soft.cpp equivalent)
  parallel/             mesh sharding (new; the reference is single-threaded)
"""

from .config import DemodConfig
from .state import DemodState, init_state, reconfigure
from .models.psk import DemodOutputs, demod_block, demod_init, make_demod_fn

__version__ = "0.1.0"

__all__ = [
    "DemodConfig",
    "DemodState",
    "DemodOutputs",
    "init_state",
    "reconfigure",
    "demod_block",
    "demod_init",
    "make_demod_fn",
]
