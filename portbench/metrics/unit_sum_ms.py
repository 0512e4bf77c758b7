"""The unit sum's device time a product: the operations launched inside
the program's ``spmv.unit_sum`` spans, ``bell_spmm`` left out, per
``spmv.call``, in the traced slice."""
from portbench.phases import per_call_ms


def read(run):
    return per_call_ms(run, "spmv.unit_sum")
