"""Images completed per merged call: completed images over the rise of the
batcher's ``merged_calls`` counter in the window."""


def read(r):
    return r.images / r.merged_calls if r.merged_calls else None
