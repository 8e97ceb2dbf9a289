"""prefetch.useful_share: the fields the Framer read in the window over the
fields that the batches dispatched in the window decoded (batches x batch
size); speculative fields that no frame used are the waste."""


def read(run):
    b, a = run.before, run.after
    decoded = (a['batches'] - b['batches']) * a['batch']
    if decoded <= 0:
        return None
    return (a['fields_read'] - b['fields_read']) / decoded
