"""build_s: host seconds of the entry's build (`build_df32`), ended by a
device sync."""


def read(run, trace):
    return run["build_s"]
