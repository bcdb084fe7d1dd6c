"""Coordinator lease plane — the ONE audited module for lease files,
expiry claims, and fencing.

The PyTorch port's copy of ``presto_tpu/server/lease.py`` (pure Python;
the lease and claim files are the reference's).

Reference parity: Presto's disaggregated-coordinator direction keeps N
coordinators honest about shared state through a resource manager;
this repo's equivalent is a directory of lease files beside the
admission journals. Each coordinator owns exactly one lease file::

    <dir>/lease-<owner>.json        (atomic-rename updates)
    <dir>/claim-<owner>.json        (O_EXCL create, fencing epoch)

A lease carries the owner's id, serving URI, fencing epoch, a
wall-clock heartbeat, and an opaque ``state`` payload — the channel
peers use to share admission occupancy, memory-quota usage, QoS-lane
counts, and the set of statement ids each coordinator can serve.
Renewal is an atomic rename (write tmp, ``os.replace``), so a reader
never observes a torn lease; ``fcntl`` is deliberately NOT the
primitive — rename is atomic on every POSIX filesystem the journal
already depends on, while advisory locks die silently over NFS.

**Expiry + claims.** A lease older than its TTL is expired: the owner
stopped renewing (crash, partition, fault-plane kill). A survivor
claims the dead owner's journal by creating ``claim-<owner>.json``
with ``O_CREAT | O_EXCL`` — the filesystem picks exactly one winner —
carrying a fencing epoch strictly greater than both the dead lease's
epoch and any prior claim's. A claim whose claimant has ITSELF gone
dead is stale and may be superseded (atomic replace, epoch bumped
again): failover must survive the failover-er failing.

**Fencing.** Before (and while) a claimant writes into the claimed
journal it calls :meth:`check_fence` — the claim file must still name
it at its epoch, else :class:`FencedError`. A claimant that stalled
past its own TTL and was superseded gets its writes REJECTED, never
interleaved: split-brain double-resume is structurally impossible.

Construction, claims, fencing, and the ``lease-``/``claim-`` file-name
prefixes are confined to this module (``tools/analyze.py`` rule
``lease-plane``); the coordinator is the one audited consumer.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import uuid
from typing import Dict, List, Optional

from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.lease")

#: default lease TTL (``lease.ttl-s``): a lease not renewed for this
#: long is expired and its journal claimable. Renewal runs at TTL/3,
#: so two missed heartbeats never expire a healthy owner.
DEFAULT_TTL_S = 10.0

_LEASE_PREFIX = "lease-"
_CLAIM_PREFIX = "claim-"
_SUFFIX = ".json"


class FencedError(RuntimeError):
    """A claimant's fencing epoch was superseded: its claim file no
    longer names it. Every write it intended against the claimed
    journal must be abandoned."""


@dataclasses.dataclass
class Lease:
    """One parsed lease (or claim) file."""

    owner: str
    uri: str = ""
    epoch: int = 0
    ts: float = 0.0
    state: dict = dataclasses.field(default_factory=dict)
    #: claim files only: who claimed this owner's journal
    claimant: str = ""

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.time()) - self.ts


class LeasePlane:
    """One coordinator's handle on the shared lease directory."""

    def __init__(
        self,
        path: str,
        owner: str,
        uri: str = "",
        ttl_s: float = DEFAULT_TTL_S,
    ):
        self.path = path
        self.owner = owner
        self.uri = uri
        self.ttl_s = max(float(ttl_s), 0.1)
        os.makedirs(path, exist_ok=True)
        # fencing epoch: strictly greater than anything this owner
        # name has carried before (a restarted coordinator rejoins
        # ABOVE the epoch a claimant may have fenced it at)
        prev = self._read(self._lease_path(owner))
        claim = self._read(self._claim_path(owner))
        self.epoch = (
            max(
                prev.epoch if prev else 0,
                claim.epoch if claim else 0,
            )
            + 1
        )

    # ------------------------------------------------------------ paths

    def _lease_path(self, owner: str) -> str:
        return os.path.join(self.path, f"{_LEASE_PREFIX}{owner}{_SUFFIX}")

    def _claim_path(self, owner: str) -> str:
        return os.path.join(self.path, f"{_CLAIM_PREFIX}{owner}{_SUFFIX}")

    # ------------------------------------------------------------- file

    @staticmethod
    def _read(path: str) -> Optional[Lease]:
        try:
            with open(path, encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(d, dict) or not d.get("owner"):
            return None
        return Lease(
            owner=str(d["owner"]),
            uri=str(d.get("uri", "")),
            epoch=int(d.get("epoch", 0)),
            ts=float(d.get("ts", 0.0)),
            state=dict(d.get("state") or {}),
            claimant=str(d.get("claimant", "")),
        )

    def _write_atomic(self, path: str, payload: dict) -> None:
        """Torn-read-proof write: tmp file + atomic rename. The tmp
        name carries a nonce so two processes racing one target never
        collide on the intermediate."""
        tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
            f.flush()
        os.replace(tmp, path)

    # ------------------------------------------------------------ renew

    def renew(self, state: Optional[dict] = None) -> None:
        """Heartbeat: re-publish this owner's lease with a fresh
        timestamp and the current shared-state payload. Atomic — peers
        read either the previous lease or this one, never a tear (the
        single writer is the owner's lease loop; no lock needed, the
        rename IS the publish)."""
        self._write_atomic(
            self._lease_path(self.owner),
            {
                "owner": self.owner,
                "uri": self.uri,
                "epoch": self.epoch,
                "ts": time.time(),
                "state": state or {},
            },
        )
        REGISTRY.counter("lease.renewals").update()

    # ------------------------------------------------------------- read

    def peers(self, live_only: bool = False) -> List[Lease]:
        """Every OTHER owner's lease; ``live_only`` filters to leases
        inside the TTL."""
        out: List[Lease] = []
        now = time.time()
        try:
            names = sorted(os.listdir(self.path))
        except OSError:
            return out
        for name in names:
            if not (
                name.startswith(_LEASE_PREFIX) and name.endswith(_SUFFIX)
            ):
                continue
            lease = self._read(os.path.join(self.path, name))
            if lease is None or lease.owner == self.owner:
                continue
            if live_only and lease.age(now) > self.ttl_s:
                continue
            out.append(lease)
        return out

    def read_lease(self, owner: str) -> Optional[Lease]:
        return self._read(self._lease_path(owner))

    def is_expired(self, lease: Lease) -> bool:
        return lease.age() > self.ttl_s

    # ------------------------------------------------------------ claim

    def claim_expired(self, owner: str) -> Optional[Lease]:
        """Claim a dead owner's journal. Returns the claim (fencing
        epoch included) when THIS plane won, None when the owner is
        still live, already retired, or another claimant holds a live
        claim. Exactly-one-winner rides ``O_CREAT | O_EXCL``; a STALE
        claim (its claimant's own lease expired) is superseded by
        atomic replace at a strictly higher epoch."""
        lease = self.read_lease(owner)
        if lease is None or not self.is_expired(lease):
            return None
        cpath = self._claim_path(owner)
        prior = self._read(cpath)
        if prior is not None:
            claimant = self.read_lease(prior.claimant)
            if claimant is not None and not self.is_expired(claimant):
                return None  # live claimant: the claim stands
            # stale claim: supersede it ABOVE both epochs so the old
            # claimant's fence check can never pass again
            claim = Lease(
                owner=owner,
                claimant=self.owner,
                epoch=max(lease.epoch, prior.epoch) + 1,
                ts=time.time(),
            )
            self._write_atomic(
                cpath,
                {
                    "owner": owner,
                    "claimant": self.owner,
                    "epoch": claim.epoch,
                    "ts": claim.ts,
                },
            )
            REGISTRY.counter("lease.claims").update()
            return claim
        claim = Lease(
            owner=owner,
            claimant=self.owner,
            epoch=lease.epoch + 1,
            ts=time.time(),
        )
        try:
            fd = os.open(cpath, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None  # lost the race: exactly one winner
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "owner": owner,
                        "claimant": self.owner,
                        "epoch": claim.epoch,
                        "ts": claim.ts,
                    },
                    f,
                )
                f.flush()
        except OSError:
            return None
        REGISTRY.counter("lease.claims").update()
        return claim

    def check_fence(self, claim: Lease) -> None:
        """Raise :class:`FencedError` unless ``claim`` is still the
        current claim on its owner's journal — called before every
        write a claimant makes into claimed state."""
        cur = self._read(self._claim_path(claim.owner))
        if (
            cur is None
            or cur.claimant != self.owner
            or cur.epoch != claim.epoch
        ):
            REGISTRY.counter("lease.fenced_writes").update()
            raise FencedError(
                f"claim on {claim.owner} (epoch {claim.epoch}) "
                "superseded"
            )

    def retire(self, owner: str) -> None:
        """Drop a fully failed-over owner's lease + claim files: its
        journal was replayed and closed out, there is nothing left to
        claim. Idempotent."""
        for p in (self._lease_path(owner), self._claim_path(owner)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def stop(self) -> None:
        """Withdraw this owner's lease (clean shutdown): peers see an
        absent lease, not an expiring one, so nothing claims a journal
        the owner closed out itself."""
        try:
            os.unlink(self._lease_path(self.owner))
        except OSError:
            pass
