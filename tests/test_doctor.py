"""Doctor diagnostics tests (vampomi_tpu/doctor.py) — host-side checks only;
the real-device probe is exercised for its timeout behavior (it must never
hang the doctor, whatever the device is doing) and its report line is
checked against faked probe output."""

from vampomi_tpu import doctor


def test_host_side_checks_pass(capsys):
    assert doctor.check_python_deps()
    assert doctor.check_compile_cache()
    assert doctor.check_math()
    doctor.check_native_ext()  # PASS or WARN, both truthy lines
    out = capsys.readouterr().out
    for name in ("python deps", "compile cache", "math kernels",
                 "native extension"):
        assert name in out
    assert "FAIL" not in out


def test_device_probe_times_out_instead_of_hanging(capsys):
    # 0.2 s is shorter than any fresh interpreter can import jax: the probe
    # must report FAIL (hang) quickly rather than blocking on a dead device
    assert doctor.check_device(timeout_s=0.2) is False
    assert "hang" in capsys.readouterr().out


def test_device_line_reports_platform_and_kind():
    status, detail = doctor.device_line(
        "noise\ngpu|NVIDIA H100 80GB HBM3|1|512|0.31\n", 2.5)
    assert status == "PASS"
    assert "1x gpu (NVIDIA H100 80GB HBM3)" in detail and "0.31s" in detail

    status, detail = doctor.device_line("cpu|cpu|8|512|0.01", 1.0)
    assert status == "WARN" and "no accelerator visible" in detail
    assert "8x cpu" in detail

    status, detail = doctor.device_line("gpu|NVIDIA H100|1|511|0.02", 1.0)
    assert status == "FAIL" and "expected 512" in detail
