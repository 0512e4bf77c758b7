"""One rank through the exchange's three steps, for the port's tests.

Over a ``LocalCommunicator`` the step composes each exchange into one
gather of x; :class:`OneRankChain` is a ``Communicator`` that is not a
``LocalCommunicator``, so a step built over it runs the owned blocks,
the send buffer and the workspace gather, with its collectives the
identity. The two steps, on one plan, must agree bitwise::

    from _torch_one_rank import OneRankChain
"""
from repro_torch.pmvc.dist import Communicator


class OneRankChain(Communicator):
    """A one-rank :class:`Communicator` with no process group whose
    ``all_to_all`` hands back its input and whose ``psum`` is the
    identity."""

    def __init__(self):
        self.group, self.world, self.rank, self.log = None, 1, 0, None

    def all_to_all(self, send):
        return send.contiguous(), self

    def wait(self):
        return None

    def psum(self, y):
        return y
