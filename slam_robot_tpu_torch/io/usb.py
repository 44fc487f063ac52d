"""libusb-1.0 transport via ctypes (usb.h rebuilt, no compiled shim needed).

This package's own copy of ``slam_robot_tpu/io/usb.py``.

The reference wraps libusb in a RAII context + vendor/product enumeration
(usb.h:9-64) and issues vendor control transfers (vehicle.cpp:37-39,67-68).
``UsbDevice.control_transfer(request, value, index)`` is exactly the
transport signature ``models/vehicle.HostVehicle`` expects.
"""

from __future__ import annotations

import ctypes
import ctypes.util


class _Descriptor(ctypes.Structure):
    _fields_ = [
        ("bLength", ctypes.c_uint8),
        ("bDescriptorType", ctypes.c_uint8),
        ("bcdUSB", ctypes.c_uint16),
        ("bDeviceClass", ctypes.c_uint8),
        ("bDeviceSubClass", ctypes.c_uint8),
        ("bDeviceProtocol", ctypes.c_uint8),
        ("bMaxPacketSize0", ctypes.c_uint8),
        ("idVendor", ctypes.c_uint16),
        ("idProduct", ctypes.c_uint16),
        ("bcdDevice", ctypes.c_uint16),
        ("iManufacturer", ctypes.c_uint8),
        ("iProduct", ctypes.c_uint8),
        ("iSerialNumber", ctypes.c_uint8),
        ("bNumConfigurations", ctypes.c_uint8),
    ]


def _load():
    name = ctypes.util.find_library("usb-1.0") or "libusb-1.0.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.libusb_init.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.libusb_get_device_list.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p))
    ]
    lib.libusb_get_device_list.restype = ctypes.c_ssize_t
    lib.libusb_get_device_descriptor.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Descriptor)
    ]
    lib.libusb_open.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.libusb_control_transfer.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint16,
        ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint,
    ]
    return lib


class Usb:
    """libusb context (usb.h:9-26)."""

    def __init__(self):
        self.lib = _load()
        self.ctx = ctypes.c_void_p()
        self.ok = bool(self.lib) and self.lib.libusb_init(ctypes.byref(self.ctx)) == 0


class UsbDevice:
    """Open the first device matching vendor_id and any of product_ids
    (UsbDevice::Init, usb.h:46-64)."""

    def __init__(self, usb: Usb, vendor_id: int, product_ids):
        self.handle = None
        if not usb.ok:
            return
        lib = usb.lib
        devs = ctypes.POINTER(ctypes.c_void_p)()
        n = lib.libusb_get_device_list(usb.ctx, ctypes.byref(devs))
        try:
            for i in range(max(n, 0)):
                d = _Descriptor()
                if lib.libusb_get_device_descriptor(devs[i], ctypes.byref(d)) != 0:
                    continue
                if d.idVendor == vendor_id and d.idProduct in product_ids:
                    h = ctypes.c_void_p()
                    if lib.libusb_open(devs[i], ctypes.byref(h)) == 0:
                        self.handle = h
                        self.lib = lib
                        return
        finally:
            if n >= 0:
                lib.libusb_free_device_list(devs, 1)

    def control_transfer(self, request: int, value: int, index: int,
                         timeout_ms: int = 5000) -> int:
        """Vendor OUT control transfer, the reference's exact call shape
        (0x40, request, value, index; vehicle.cpp:37-39)."""
        if self.handle is None:
            return -1
        return self.lib.libusb_control_transfer(
            self.handle, 0x40, request, value, index, None, 0, timeout_ms
        )


POLOLU_VENDOR = 0x1FFB
MAESTRO_PRODUCTS = (0x0089, 0x008A, 0x008B, 0x008C)          # vehicle.cpp:27
SMC_PRODUCTS = (0x0098, 0x009A, 0x009C, 0x009E, 0x00A1)      # vehicle.cpp:52


def pololu_transport():
    """Transport callable for models/vehicle.HostVehicle bound to real
    Pololu hardware; None when no devices are attached."""
    usb = Usb()
    if not usb.ok:
        return None
    maestro = UsbDevice(usb, POLOLU_VENDOR, MAESTRO_PRODUCTS)
    smc = UsbDevice(usb, POLOLU_VENDOR, SMC_PRODUCTS)
    if maestro.handle is None and smc.handle is None:
        return None

    from slam_robot_tpu_torch.models import vehicle as v

    def transport(request: int, value: int, index: int) -> None:
        dev = maestro if request == v.REQUEST_SET_TARGET else smc
        dev.control_transfer(request, value, index)

    return transport
