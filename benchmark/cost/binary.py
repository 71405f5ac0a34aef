"""Bytes and operations of the binary log-loss gradient pass: each row's
score and label read (float32), gradient and hessian written (float32);
about ten operations a row (a product, an exponential, a division and
the hessian's three)."""


def gradients(num_data: int):
    return num_data * 16, num_data * 10
