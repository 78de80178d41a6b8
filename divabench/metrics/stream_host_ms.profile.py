"""stream_host_ms.profile: mean ms of host work a
``stream_profile_population`` chunk adds around its device program (the
program's ``stream.lower``, ``stream.prep``, ``stream.readback`` and
``stream.fold`` spans) in the traced window."""
from divabench.metrics._stages import host_ms


def read(run):
    return host_ms(run, "stream_profile")
