"""Trust / finality policies gating proof verification.

Reference parity: `TrustPolicy::{AcceptAll, F3Certificate}` and the
`TrustVerifier` trait (`src/proofs/trust/mod.rs`). The F3 branch goes beyond
the reference's stub (epoch-range only, acknowledged TODOs at
`trust/mod.rs:58,72`): by default the *claimed CIDs* must appear in the
certificate's EC chain (exact tipset-key match for the parent, member-block
match for the child header) — see `cert.validates_parent_tipset` /
`validates_child_header`. Pass ``bind_tipsets=False`` to
`with_f3_certificate` for the reference's epoch-only semantics. BLS
aggregate-signature + quorum verification is available via
``with_f3_certificate(verify_signature=True, power_table=…)`` (see
`cert.FinalityCertificate.verify_signature` and `crypto/bls.py`), closing
the reference's TODOs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.cert import FinalityCertificate

__all__ = ["TrustPolicy", "TrustVerifier", "MockTrustVerifier", "CustomVerifier"]


class TrustVerifier(Protocol):
    """Custom trust verification logic (reference `trust/mod.rs:31-37`)."""

    def verify_parent_tipset(self, epoch: int, cids: list[CID]) -> bool: ...

    def verify_child_header(self, epoch: int, cid: CID) -> bool: ...


@dataclass
class MockTrustVerifier:
    """Canned-answer fixture (reference `trust/mod.rs:82-95`)."""

    parent_result: bool = True
    child_result: bool = True

    def verify_parent_tipset(self, epoch: int, cids: list[CID]) -> bool:
        return self.parent_result

    def verify_child_header(self, epoch: int, cid: CID) -> bool:
        return self.child_result


@dataclass
class CustomVerifier:
    verifier: TrustVerifier


class TrustPolicy:
    """AcceptAll (testing only) | F3 certificate | custom verifier."""

    def __init__(
        self,
        accept_all: bool = False,
        certificate: Optional[FinalityCertificate] = None,
        custom: Optional[TrustVerifier] = None,
        bind_tipsets: bool = True,
    ):
        if sum(x is not None and x is not False for x in (accept_all, certificate, custom)) != 1:
            raise ValueError("exactly one of accept_all/certificate/custom required")
        self._accept_all = accept_all
        self._certificate = certificate
        self._custom = custom
        self._bind_tipsets = bind_tipsets

    @classmethod
    def accept_all(cls) -> "TrustPolicy":
        """WARNING: development/testing only."""
        return cls(accept_all=True)

    @classmethod
    def with_f3_certificate(
        cls,
        cert: FinalityCertificate,
        bind_tipsets: bool = True,
        verify_signature: bool = False,
        power_table=None,
    ) -> "TrustPolicy":
        """Trust proofs anchored by an F3 finality certificate.

        With ``bind_tipsets`` (the default) the claimed parent tipset key /
        child block CID must appear in the cert's EC chain at the claimed
        epoch; ``bind_tipsets=False`` reproduces the reference's epoch-range
        stub (`trust/mod.rs:53-78`).

        ``verify_signature=True`` verifies the certificate's aggregate BLS
        signature and >2/3 power quorum against ``power_table`` (the
        committee for the cert's instance) AT CONSTRUCTION, raising
        ValueError for a forged/under-quorum certificate — closing the
        reference's TODO at `trust/mod.rs:58,72`. Requires ``power_table``
        (a sequence of `cert.PowerTableEntry`).
        """
        if verify_signature:
            if power_table is None:
                raise ValueError("verify_signature=True requires power_table")
            cert.verify_signature(power_table)
        return cls(certificate=cert, bind_tipsets=bind_tipsets)

    @classmethod
    def with_custom_verifier(cls, verifier: TrustVerifier) -> "TrustPolicy":
        return cls(custom=verifier)

    def verify_parent_tipset(self, epoch: int, cids: list[CID]) -> bool:
        if self._accept_all:
            return True
        if self._certificate is not None:
            if self._bind_tipsets:
                return self._certificate.validates_parent_tipset(
                    epoch, [str(c) for c in cids]
                )
            return self._certificate.is_valid_for_epoch(epoch)
        return self._custom.verify_parent_tipset(epoch, cids)

    def verify_child_header(self, epoch: int, cid: CID) -> bool:
        if self._accept_all:
            return True
        if self._certificate is not None:
            if self._bind_tipsets:
                return self._certificate.validates_child_header(epoch, str(cid))
            return self._certificate.is_valid_for_epoch(epoch)
        return self._custom.verify_child_header(epoch, cid)
