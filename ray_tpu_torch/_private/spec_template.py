"""Pre-serialized TaskSpec templates: patch, don't pickle.

The driver submit profile (PROFILE_r08_driver_submit.folded) attributes
~40% of the submit hot path to spec construction — ``TaskSpec.__init__``
plus a full ``pickle.dumps`` per call — even though for a given
``RemoteFunction`` every field except the task id, the args blob, and
the submit timestamp is CONSTANT across submissions. The reference
solves this by building specs off the Python caller thread in C++
(reference: core_worker.h:735 SubmitTask); we instead freeze the
constant fields into a pickled skeleton ONCE and splice the three
variable slots into a copy of the bytes per call.

Why byte-patching is sound here: with protocol 5, CPython's pickler
emits MEMOIZE (``\\x94``) without an embedded index — memo indices only
appear in GET opcodes, which only occur for objects referenced twice
within one pickle. A TaskSpec's variable slots always memoize the same
NUMBER of objects regardless of their value (a TaskID is always
class+bytes+tuple+reduce, an args blob is always one bytes object), so
every offset and index in the constant segments is value-independent.
The two length-dependent pieces — the args blob's own opcode framing
and the protocol-4 FRAME header — are re-emitted/re-written per call.

Every template self-checks at build time (patched bytes must equal
``pickle.dumps`` of an equivalently constructed spec for probe values)
and refuses to build if the structure doesn't match — a future pickler
change degrades to the classic path, never to wrong bytes. The
``submit_template_verify`` knob extends that check to EVERY call.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.task_spec import TaskSpec

_PROTO = 5
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_F64BE = struct.Struct(">d")
# CPython's pickler ends the current frame and writes byte payloads of
# at least _FRAME_SIZE_TARGET (64 KiB) unframed; it also commits a new
# frame once the running frame reaches that size. Either changes the
# opcode layout the template froze, so calls whose patched size could
# cross it decline to the classic path.
_FRAME_SAFE_TOTAL = 60 * 1024

MEMOIZE = b"\x94"
SHORT_BINBYTES = b"C"
BINBYTES = b"B"


class TemplateUnavailable(Exception):
    """The spec pickle's structure doesn't match template assumptions
    (different interpreter/pickler); callers fall back to classic
    construction."""


def encode_bytes(b: bytes) -> bytes:
    """The pickler's exact encoding of a (fresh, framed) bytes object."""
    n = len(b)
    if n < 256:
        return SHORT_BINBYTES + bytes((n,)) + b + MEMOIZE
    if n < (1 << 32):
        return BINBYTES + _U32.pack(n) + b + MEMOIZE
    raise TemplateUnavailable("args blob too large for template")


def _marker_float() -> Tuple[float, bytes]:
    # A random normal double (exponent pinned off the inf/nan pattern):
    # round-trips through pack/unpack bit-identically.
    raw = b"\x3f\xd5" + os.urandom(6)
    return struct.unpack(">d", raw)[0], raw


class SpecTemplate:
    """Frozen pickled skeleton of one RemoteFunction's TaskSpec.

    Variable slots: ``task_id`` (fixed-width splice), ``args`` (re-encoded
    bytes), ``submitted_at`` (fixed-width splice). Everything else —
    including ``arg_deps=[]`` and ``trace_ctx=None`` — is frozen; calls
    that need other values (dep-carrying args, traced submissions,
    spilled arg blobs) must use classic construction.
    """

    __slots__ = ("_const", "_pre", "_frame_tail", "_seg1", "_seg2",
                 "_seg3", "_framed", "_frame_len0", "_base_enc_len",
                 "_base_total", "_verify", "_head_memo", "max_args")

    def __init__(self, const_fields: Dict[str, Any]):
        """``const_fields``: every TaskSpec field except task_id, args,
        submitted_at. ``arg_deps`` must be empty and ``trace_ctx`` None
        (they are frozen into the skeleton)."""
        if const_fields.get("arg_deps"):
            raise TemplateUnavailable("arg_deps must be frozen empty")
        if const_fields.get("trace_ctx") is not None:
            raise TemplateUnavailable("trace_ctx must be frozen None")
        self._const = dict(const_fields)
        self._const["arg_deps"] = []
        self._const["trace_ctx"] = None

        tid_marker = os.urandom(TaskID.SIZE)
        args_marker = os.urandom(32)
        f_marker, f_raw = _marker_float()
        proto = TaskSpec(task_id=TaskID(tid_marker), args=args_marker,
                         submitted_at=f_marker, **self._const)
        data = pickle.dumps(proto, protocol=_PROTO)

        if data.count(tid_marker) != 1:
            raise TemplateUnavailable("task-id marker not unique")
        args_enc = encode_bytes(args_marker)
        if data.count(args_enc) != 1:
            raise TemplateUnavailable("args marker not unique")
        f_enc = b"G" + f_raw
        if data.count(f_enc) != 1:
            raise TemplateUnavailable("timestamp marker not unique")
        i_tid = data.index(tid_marker)
        i_args = data.index(args_enc)
        i_f = data.index(f_enc)
        if not (i_tid < i_args < i_f):
            raise TemplateUnavailable("unexpected field ordering")

        self._framed = data[:2] == b"\x80\x05" and data[2:3] == b"\x95"
        if self._framed:
            self._frame_len0 = _U64.unpack(data[3:11])[0]
            self._pre = data[:3]
            self._frame_tail = data[11:i_tid]
        else:
            self._frame_len0 = 0
            self._pre = b""
            self._frame_tail = data[:i_tid]
        self._seg1 = data[i_tid + TaskID.SIZE:i_args]
        self._seg2 = data[i_args + len(args_enc):i_f + 1]  # keeps 'G'
        self._seg3 = data[i_f + 9:]
        self._base_enc_len = len(args_enc)
        self._base_total = len(data)
        self._verify = False  # resolved lazily from config per call
        # Inline-able accepts() bound: args must be bytes shorter than
        # this (callers check `len(args) < tpl.max_args` plus the
        # deps/trace gates without a method call).
        self.max_args = max(0, _FRAME_SAFE_TOTAL - self._base_total)
        # Frame-header memo keyed by args-length delta: submissions of a
        # given RemoteFunction overwhelmingly share one args size (often
        # the shared empty blob), so the rewritten FRAME head is reused.
        self._head_memo: Dict[int, bytes] = {}

        # Build-time self-check: the patch must reproduce pickle.dumps
        # exactly for probe values spanning the bytes-opcode boundary.
        for probe_args in (b"", os.urandom(100), os.urandom(300)):
            probe_tid = TaskID.from_random()
            probe_t = 1.5e9 + 0.125
            got = self.patch(probe_tid.binary(), probe_args, probe_t)
            want = pickle.dumps(
                TaskSpec(task_id=probe_tid, args=probe_args,
                         submitted_at=probe_t, **self._const),
                protocol=_PROTO)
            if got != want:
                raise TemplateUnavailable("patched bytes != fresh pickle")

    def accepts(self, args: Any, arg_deps, trace_ctx) -> bool:
        """Can this call ride the template? (The submit hot path inlines
        these checks via ``max_args``; this method is the readable
        equivalent for everyone else.)"""
        return (type(args) is bytes and not arg_deps and trace_ctx is None
                and len(args) < self.max_args)

    def patch(self, tid_bytes: bytes, args: bytes,
              submitted_at: float) -> bytes:
        """Splice the variable slots into a copy of the skeleton bytes.
        Returns exactly what ``pickle.dumps(spec, protocol=5)`` would."""
        enc = encode_bytes(args)
        if self._framed:
            delta = len(enc) - self._base_enc_len
            head = self._head_memo.get(delta)
            if head is None:
                head = self._pre + _U64.pack(self._frame_len0 + delta) \
                    + self._frame_tail
                if len(self._head_memo) < 64:
                    self._head_memo[delta] = head
        else:
            head = self._frame_tail
        return b"".join((head, tid_bytes, self._seg1, enc, self._seg2,
                         _F64BE.pack(submitted_at), self._seg3))

    def make_lazy(self, task_id: TaskID, args: bytes,
                  submitted_at: float) -> TaskSpec:
        """Build the spec object WITHOUT running TaskSpec.__init__ and
        WITHOUT patching: the template ref rides along as ``_tpl`` and
        ``spec_wire`` patches on first use — which for queued/coalesced
        specs happens on the lease executor or flush thread, keeping the
        caller's critical path to a dict update. Neither ``_tpl`` nor
        ``_wire`` is pickled state (__getstate__ walks _STATE_FIELDS)."""
        spec = TaskSpec.__new__(TaskSpec)
        d = spec.__dict__
        d.update(self._const)
        # Fresh list per spec: arg_deps is mutable and must never be
        # shared across submissions.
        d["arg_deps"] = []
        d["task_id"] = task_id
        d["args"] = args
        d["submitted_at"] = submitted_at
        d["_tpl"] = self
        return spec

    def make(self, task_id: TaskID, args: bytes,
             submitted_at: float) -> TaskSpec:
        """make_lazy + eager patch (the verify path: every blob checked
        against a fresh pickle)."""
        spec = self.make_lazy(task_id, args, submitted_at)
        blob = spec.__dict__["_wire"] = self.patch(
            task_id.binary(), args, submitted_at)
        if self._verify:
            fresh = pickle.dumps(
                TaskSpec(task_id=task_id, args=args,
                         submitted_at=submitted_at, **self._const),
                protocol=_PROTO)
            if blob != fresh:
                raise AssertionError(
                    "spec template verify: patched bytes != fresh pickle "
                    f"({len(blob)} vs {len(fresh)} bytes)")
        return spec

    def set_verify(self, on: bool) -> None:
        self._verify = bool(on)


def build(const_fields: Dict[str, Any]) -> Optional[SpecTemplate]:
    """Build a template, or None when the structure can't be templated
    (non-bytes constants that confuse the probe, exotic picklers...).
    Never raises: template construction is an optimization, not a
    contract."""
    try:
        return SpecTemplate(const_fields)
    except Exception:
        return None


def spec_wire(spec) -> bytes:
    """The spec's wire blob: cached patched bytes, a deferred template
    patch (make_lazy — runs wherever the frame is being assembled, off
    the submit hot path), or a fresh pickle. Callers that MUTATE a spec
    (retry budget rewrites) must call ``invalidate_wire`` first."""
    d = spec.__dict__
    w = d.get("_wire")
    if w is None:
        tpl = d.get("_tpl")
        if tpl is not None:
            w = d["_wire"] = tpl.patch(
                d["task_id"]._bytes, d["args"], d["submitted_at"])
        else:
            w = pickle.dumps(spec, protocol=_PROTO)
    return w


def invalidate_wire(spec) -> None:
    """Drop the cached blob AND the template binding: a mutated spec's
    constants no longer match the frozen skeleton."""
    spec.__dict__.pop("_wire", None)
    spec.__dict__.pop("_tpl", None)
