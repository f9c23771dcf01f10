"""Scaling-efficiency harness on the virtual 8-device CPU mesh (VERDICT
round-1 item 4: the BASELINE.md >=85% 1-chip->N-hosts axis needs a
measurement harness runnable today and unchanged on real hardware)."""


from psk_soft_tpu import DemodConfig
from psk_soft_tpu.eval.scaling import channel_scaling_report, time_shard_report

CFG = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)


def test_channel_weak_scaling_report():
    rep = channel_scaling_report(CFG, device_counts=[1, 2, 4],
                                 channels_per_device=16, symbols=64,
                                 iters=2, reps=2)
    assert rep["mode"] == "channel-weak"
    pts = rep["points"]
    assert [p["devices"] for p in pts] == [1, 2, 4]
    assert [p["channels"] for p in pts] == [16, 32, 64]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0 and p["throughput_sps"] > 0
        # CPU virtual devices share host cores, so no >=85% assertion here;
        # the harness just has to produce a meaningful curve.
        assert 0.01 < p["efficiency"] <= 4.0


def test_chain_weak_scaling_report():
    from psk_soft_tpu.eval.scaling import chain_scaling_report

    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4,
                      phase_avg=50)
    rep = chain_scaling_report(cfg, device_counts=[1, 2],
                               channels_per_device=128, symbols=512,
                               iters=1, reps=1)
    assert rep["mode"] == "chain-weak (seam)"
    assert rep["frames_per_block_per_channel"] >= 1
    pts = rep["points"]
    assert [p["devices"] for p in pts] == [1, 2]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0 and p["infobits_per_s"] > 0


def test_time_strong_scaling_report():
    rep = time_shard_report(CFG, time_counts=[1, 2, 4], channels=128,
                            total_symbols=1024, iters=1, reps=1)
    pts = rep["points"]
    assert [p["time_shards"] for p in pts] == [1, 2, 4]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0
