"""Host seconds of ``fitter.load_data_for_fitting`` in the set-up of the whole-shot fit."""


def read(ctx):
    return ctx["setup"].get("prepare_s")
