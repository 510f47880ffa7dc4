"""Host ms a batch from the first copy to the host to the CSR block: the
copies (which wait for the batch's device work), the float64 sums and
`csr_block`, from the host clock in the traced run's window."""


def read(run):
    value = run.host_s.get("host_per_batch")
    return None if value is None else 1e3 * value
