"""The card's energy and power limit from NVML, through ``ctypes`` on
``libnvidia-ml.so.1`` (no Python binding needed).

The NVML device is the one whose UUID is CUDA device 0's.  Energy is
``nvmlDeviceGetTotalEnergyConsumption`` (millijoules since the GPU module
loaded); a card without that counter fails the run.
"""

from __future__ import annotations

import ctypes
from typing import Optional

NVML_SUCCESS = 0


class NvmlError(RuntimeError):
    pass


class Card:
    """One card's NVML handle.  ``close()`` shuts NVML down."""

    def __init__(self, uuid: Optional[str]):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._call("nvmlInit_v2")
        try:
            self.handle = self._find(uuid)
        except BaseException:
            self.lib.nvmlShutdown()
            raise

    def _call(self, name: str, *args) -> None:
        fn = getattr(self.lib, name)
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{name} returned {rc}")

    def _find(self, uuid: Optional[str]):
        count = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(count))
        want = (uuid or "").lower().removeprefix("gpu-")
        for i in range(count.value):
            handle = ctypes.c_void_p()
            self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(i),
                       ctypes.byref(handle))
            buf = ctypes.create_string_buffer(96)
            self._call("nvmlDeviceGetUUID", handle, buf, ctypes.c_uint(96))
            got = buf.value.decode().lower().removeprefix("gpu-")
            if got == want or (not want and count.value == 1):
                return handle
        raise NvmlError(f"no NVML device has the UUID {uuid!r}")

    def energy_mj(self) -> int:
        out = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(out))
        return out.value

    def power_limit_w(self) -> float:
        out = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", self.handle,
                   ctypes.byref(out))
        return out.value / 1000.0

    def close(self) -> None:
        self.lib.nvmlShutdown()


class EnergyMeter:
    """Joules the card used between ``start()`` and ``stop()``, from its
    total-energy counter (``NvmlError`` where the card has none)."""

    def __init__(self, card: Card):
        self.card = card
        card.energy_mj()

    def start(self) -> None:
        self._e0 = self.card.energy_mj()

    def stop(self) -> float:
        return (self.card.energy_mj() - self._e0) / 1e3
