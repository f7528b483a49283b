"""The device's work over a window, from CUPTI's activity records.

A frozen copy of ``chip_smoke.py``'s ``DeviceTrace`` reader (the libcupti
that torch loaded, through ctypes: a ``torch.profiler`` session took seconds
to start on the card's machine): one record a kernel, memset or memcpy the
device ran, CUDA graph replays included; start at byte 16 and end at byte
24 of each record, a kernel's name at byte 104 (cupti_activity.h). Added
here: the window's own bounds and the host clock's offset, read with
``cuptiGetTimestamp``, so the benchmark's host spans can label the idle
gaps.
"""

from __future__ import annotations

import ctypes
import re
import time

KERNEL_KIND, START, END, NAME, BUFFER = 10, 16, 24, 104, 32 << 20  # CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL
OTHER_KINDS = {1: "[memcpy]", 2: "[memset]"}  # CUPTI_ACTIVITY_KIND_MEMCPY, CUPTI_ACTIVITY_KIND_MEMSET
TOP = 10  # entries of each breakdown list


def short_name(name: str) -> str:
    """A kernel's function name from its mangled name: the identifier that
    names the kernel, and the first functor or op among its template
    arguments (``vectorized_elementwise_kernel:FillFunctor``)."""
    idents, i = [], 0
    while True:
        m = re.compile(r"(\d+)").search(name, i)
        if not m:
            break
        n, end = int(m.group(1)), m.end()
        ident = name[end:end + n]
        literal = re.fullmatch(r"L[a-z]", name[max(m.start() - 2, 0):m.start()])  # Li128E: the number 128
        if n and not literal and len(ident) == n and re.fullmatch(r"[A-Za-z_]\w*", ident):
            idents.append(ident)
            i = end + n
        else:
            i = end
    k = next((j for j, x in enumerate(idents) if "kernel" in x.lower()), None)
    if k is None:
        return idents[-1] if idents else name[:80]
    extra = next((x for x in idents[k + 1:] if len(x) <= 40 and re.search(r"Functor|Op$|_op$|copy|fill", x)), None)
    return idents[k] if extra is None else f"{idents[k]}:{extra}"


class _Cupti:
    lib = callbacks = None
    active = None  # the trace the callbacks fill

    @classmethod
    def load(cls):
        if cls.lib is not None:
            return cls.lib
        paths = sorted({line.split()[-1] for line in open("/proc/self/maps") if "libcupti" in line})
        if not paths:
            raise RuntimeError("torch loaded no libcupti")
        lib = ctypes.CDLL(paths[0])
        buffers = []  # every buffer handed to CUPTI, kept alive

        @ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
                          ctypes.POINTER(ctypes.c_size_t))
        def requested(buf, size, max_records):
            raw = ctypes.create_string_buffer(BUFFER + 8)
            buffers.append(raw)
            buf[0] = (ctypes.addressof(raw) + 7) & ~7
            size[0], max_records[0] = BUFFER, 0

        @ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t)
        def completed(ctx, stream, buf, size, valid):
            rec = ctypes.c_void_p()
            while lib.cuptiActivityGetNextRecord(ctypes.c_void_p(buf), ctypes.c_size_t(valid), ctypes.byref(rec)) == 0:
                kind = ctypes.c_uint32.from_address(rec.value).value
                if cls.active is None or (kind != KERNEL_KIND and kind not in OTHER_KINDS):
                    continue
                start = ctypes.c_uint64.from_address(rec.value + START).value
                end = ctypes.c_uint64.from_address(rec.value + END).value
                if kind == KERNEL_KIND:
                    name = (ctypes.c_char_p.from_address(rec.value + NAME).value or b"").decode(errors="replace")
                else:
                    name = OTHER_KINDS[kind]
                cls.active.records.append((start, end, name))
            buffers[:] = [b for b in buffers if (ctypes.addressof(b) + 7) & ~7 != buf]

        lib.cuptiGetTimestamp.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        cls.lib, cls.callbacks = lib, (requested, completed)
        check(lib.cuptiActivityRegisterCallbacks(requested, completed), "cuptiActivityRegisterCallbacks")
        return lib


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} returned CUPTI error {rc}")


def stamp(lib) -> int:
    t = ctypes.c_uint64()
    check(lib.cuptiGetTimestamp(ctypes.byref(t)), "cuptiGetTimestamp")
    return t.value


class Trace:
    """``with Trace() as t:`` the device's records over the block, then
    ``t.busy_s``, ``t.window_s``, ``t.seconds(names)`` and ``t.breakdown()``."""

    def __enter__(self):
        import torch

        self.lib = _Cupti.load()
        self.records, self.gaps = [], []
        torch.cuda.synchronize()
        _Cupti.active = self
        for kind in (KERNEL_KIND, *OTHER_KINDS):
            check(self.lib.cuptiActivityEnable(kind), "cuptiActivityEnable")
        self.offset_ns = stamp(self.lib) - time.perf_counter_ns()
        self.open = stamp(self.lib)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.close = stamp(self.lib)
        check(self.lib.cuptiActivityFlushAll(1), "cuptiActivityFlushAll")
        for kind in (KERNEL_KIND, *OTHER_KINDS):
            check(self.lib.cuptiActivityDisable(kind), "cuptiActivityDisable")
        _Cupti.active = None
        self.records = sorted((max(s, self.open), min(e, self.close), n) for s, e, n in self.records
                              if e > self.open and s < self.close)
        self.busy = self._union()
        return False

    def _union(self):
        """The merged intervals in which some record ran."""
        out = []
        for s, e, _ in self.records:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self) -> float:
        return (self.close - self.open) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def seconds(self, patterns) -> float:
        """Device seconds of the records whose names hold any of ``patterns``."""
        return sum(e - s for s, e, n in self.records if any(p in n for p in patterns)) / 1e9

    def label_gaps(self, log):
        """Label each idle gap by the host span (of ``log``, the benchmark's
        own spans around its calls into the port) it overlaps most; time
        in no span is the harness's own."""
        spans = sorted((int(a * 1e9) + self.offset_ns, int(b * 1e9) + self.offset_ns, name)
                       for name, items in log.spans.items() for a, b in items)
        edges = [self.open] + [x for iv in self.busy for x in iv] + [self.close]
        totals = {}
        i = 0
        for gs, ge in zip(edges[::2], edges[1::2]):
            if ge <= gs:
                continue
            while i < len(spans) and spans[i][1] < gs:
                i += 1
            best, label, j = 0, "harness", i
            while j < len(spans) and spans[j][0] < ge:
                ov = min(ge, spans[j][1]) - max(gs, spans[j][0])
                if ov > best:
                    best, label = ov, spans[j][2]
                j += 1
            totals[label] = totals.get(label, 0) + (ge - gs)
        self.gaps = sorted(((k, v / 1e9) for k, v in totals.items()), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        ops = {}
        for s, e, n in self.records:
            key = short_name(n)
            ops[key] = ops.get(key, 0) + (e - s)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v / 1e9] for k, v in top], "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}
