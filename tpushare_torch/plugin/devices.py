"""Fake-device expansion, per-card memory -> one kubelet device per
memory unit: the port's copy of ``tpushare/plugin/devices.py``. IDs are
``"<uuid>-_-<j>"``, the reference plugin's scheme (nvidia.go:23-29), so
with ``NvmlBackend`` they carry the card's real ``GPU-...`` UUID.
Units are floored: an H100 80GB (79.6 GiB) expands to 79 GiB devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from tpushare_torch.deviceplugin import HEALTHY, UNHEALTHY, pb
from tpushare_torch.plugin import const
from tpushare_torch.plugin.backend import Chip, HostTopology

FAKE_ID_SEP = "-_-"


def generate_fake_device_id(uuid: str, index: int) -> str:
    """Reference: generateFakeDeviceID (nvidia.go:23-25)."""
    return f"{uuid}{FAKE_ID_SEP}{index}"


def extract_real_device_id(fake_id: str) -> str:
    """Reference: extractRealDeviceID (nvidia.go:27-29)."""
    return fake_id.split(FAKE_ID_SEP)[0]


@dataclass(frozen=True)
class DeviceMap:
    """Result of expansion: the advertised device list plus the
    uuid<->index maps Allocate needs (reference getDevices returns
    devs + map[uuid]index, nvidia.go:50-86)."""

    devices: Tuple                      # tuple[pb.Device]
    uuid_to_index: Dict[str, int]
    units_per_chip: Dict[int, int]      # chip index -> fake-device count
    memory_unit: str                    # GiB | MiB

    @property
    def index_to_uuid(self) -> Dict[int, str]:
        return {i: u for u, i in self.uuid_to_index.items()}

    def device_name_by_index(self, index: int) -> str:
        """Reference: GetDeviceNameByIndex (server.go:80-91)."""
        return self.index_to_uuid[index]

    @property
    def total_units(self) -> int:
        return sum(self.units_per_chip.values())


def chip_memory_units(chip: Chip, memory_unit: str) -> int:
    """How many fake devices one chip expands to (floor of HBM /
    unit; reference divides total mem by the unit, nvidia.go:70-73)."""
    return chip.hbm_bytes // const.MEMORY_UNIT_BYTES[memory_unit]


def expand_devices(topo: HostTopology, memory_unit: str = const.GIB) -> DeviceMap:
    """Expand a host topology into the fake device list advertised via
    ListAndWatch (reference: nvidia.go:50-86)."""
    devices: List = []
    uuid_to_index: Dict[str, int] = {}
    units_per_chip: Dict[int, int] = {}
    for chip in topo.chips:
        uuid_to_index[chip.uuid] = chip.index
        units = chip_memory_units(chip, memory_unit)
        units_per_chip[chip.index] = units
        health = HEALTHY if chip.healthy else UNHEALTHY
        topo_info = pb.TopologyInfo(nodes=[pb.NUMANode(ID=chip.numa_node)])
        for j in range(units):
            devices.append(
                pb.Device(ID=generate_fake_device_id(chip.uuid, j),
                          health=health, topology=topo_info)
            )
    return DeviceMap(devices=tuple(devices), uuid_to_index=dict(uuid_to_index),
                     units_per_chip=dict(units_per_chip), memory_unit=memory_unit)


def mark_unhealthy(devmap: DeviceMap, chip_uuid: str) -> DeviceMap:
    """Flip every fake device of one chip to Unhealthy (feeds
    ListAndWatch re-Send; reference: server.go:183-190)."""
    new = tuple(
        pb.Device(ID=d.ID, health=UNHEALTHY, topology=d.topology)
        if extract_real_device_id(d.ID) == chip_uuid
        else d
        for d in devmap.devices
    )
    return DeviceMap(devices=new, uuid_to_index=devmap.uuid_to_index,
                     units_per_chip=devmap.units_per_chip,
                     memory_unit=devmap.memory_unit)


def mark_healthy(devmap: DeviceMap, chip_uuid: str) -> DeviceMap:
    """Recovery path the reference never implemented (server.go:188 FIXME)."""
    new = tuple(
        pb.Device(ID=d.ID, health=HEALTHY, topology=d.topology)
        if extract_real_device_id(d.ID) == chip_uuid
        else d
        for d in devmap.devices
    )
    return DeviceMap(devices=new, uuid_to_index=devmap.uuid_to_index,
                     units_per_chip=devmap.units_per_chip,
                     memory_unit=devmap.memory_unit)
