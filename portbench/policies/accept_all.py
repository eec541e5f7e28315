"""Every tipset trusted as finalized (``TrustPolicy.accept_all()``): the
verdicts rest on the witness alone."""


def make(world):
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy

    return TrustPolicy.accept_all()
