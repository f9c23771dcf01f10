"""JAX version attestation + API-surface probe (CI leg).

The reference CI builds and tests against a pinned matrix
({el6, el6-i386, el7} x {REDHAWK 2.0, 2.2}, .gitlab-ci.yml:88-116) so a
toolchain drift fails loudly.  This environment cannot install alternate
jax versions (no network, no pip installs), so the equivalent protection
is two-fold:

1. **Attestation**: the interpreter's jax/jaxlib/numpy/python versions
   must match TESTED_VERSIONS.txt.  An intentional upgrade updates the
   file in the same commit (after the suite passes); an accidental one
   fails CI instead of silently shipping against an untested runtime.
   Set PSK_ALLOW_VERSION_DRIFT=1 to downgrade the failure to a warning
   (e.g. when qualifying a new version).

2. **Surface probe**: a fast smoke of every non-core JAX API this repo
   leans on (Pallas's Triton route in interpret mode, shard_map + collectives,
   static-size nonzero, reduce_window, top_k, donation-free scan carry),
   so a breaking change in a semi-private surface is caught in seconds,
   not twenty minutes into the suite.

Usage: python scripts/jax_compat_probe.py   (CPU; CI runs it on the
8-device virtual mesh).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_versions() -> int:
    import jax
    import jaxlib
    import numpy

    want = {}
    with open(os.path.join(REPO, "TESTED_VERSIONS.txt")) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                name, ver = line.split("==")
                want[name] = ver
    got = {
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "numpy": numpy.__version__,
        "python": f"{sys.version_info.major}.{sys.version_info.minor}",
    }
    drift = {k: (want.get(k), got[k]) for k in got
             if want.get(k) not in (None, got[k])}
    if not drift:
        print(f"versions match TESTED_VERSIONS.txt: {got}")
        return 0
    msg = ", ".join(f"{k}: tested {w} != running {g}"
                    for k, (w, g) in drift.items())
    if os.environ.get("PSK_ALLOW_VERSION_DRIFT"):
        print(f"WARNING: version drift allowed by env: {msg}")
        return 0
    print(f"FAIL: untested runtime versions ({msg}); run the full suite "
          f"and update TESTED_VERSIONS.txt, or set "
          f"PSK_ALLOW_VERSION_DRIFT=1", file=sys.stderr)
    return 1


def probe_surface() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    # Pallas Triton-route kernel in interpret mode (the CPU test path of
    # ops/pallas/viterbi_kernel.py: fori_loop, split/stack butterflies).
    sys.path.insert(0, REPO)
    from psk_soft_tpu.ops import fec
    from psk_soft_tpu.ops.pallas.viterbi_kernel import viterbi_decode_pallas

    bits = jnp.asarray(np.arange(24) % 3 == 0, jnp.int8)[None]
    llr = fec.hard_llrs(fec.conv_encode(fec.CODE_K3, bits))
    got = viterbi_decode_pallas(fec.CODE_K3, llr)
    assert np.array_equal(np.asarray(got), np.asarray(bits))

    # shard_map + psum/ppermute over a mesh (collective surface).
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs.reshape(len(devs)), ("d",))
    n = len(devs)

    def body(v):
        s = jax.lax.psum(v, "d")
        r = jax.lax.ppermute(v, "d", [(i, (i + 1) % n) for i in range(n)])
        return s + r

    arr = jnp.ones((n, 8), jnp.float32)
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("d"),
                                out_specs=P("d"), check_vma=False))(arr)
    assert float(out.sum()) == (n + 1) * n * 8

    # Static-size nonzero (sparse framesync), reduce_window (local max),
    # top_k (fixed-capacity sync).
    m = jnp.asarray([[True, False, True, False]])
    ci, ti = jnp.nonzero(m, size=4, fill_value=-1)
    assert list(np.asarray(ti)) == [0, 2, -1, -1]
    w = jax.lax.reduce_window(jnp.ones((2, 8), jnp.float32), -jnp.inf,
                              jax.lax.max, (1, 3), (1, 1), "VALID")
    assert w.shape == (2, 6)
    v, i = jax.lax.top_k(jnp.asarray([1, 9, 4]), 2)
    assert list(np.asarray(v)) == [9, 4]

    # scan with pytree carry (every engine's block loop).
    def step(c, _):
        return jax.tree_util.tree_map(lambda a: a + 1, c), None

    c, _ = jax.lax.scan(step, {"a": jnp.zeros(3)}, None, length=5)
    assert float(c["a"][0]) == 5.0
    print(f"jax surface probe OK on {jax.default_backend()} "
          f"({len(jax.devices())} devices)")
    return 0


if __name__ == "__main__":
    rc = check_versions()
    rc = probe_surface() or rc
    sys.exit(rc)
