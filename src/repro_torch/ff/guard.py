"""The warning class of ``repro.ff.guard`` that the port raises so far
(the guard scopes, their error taxonomy and the ``guard_flags`` kernel
come with the guarded serving engine).  ``FFTuneWarning`` lives here,
where the reference keeps it, so that a caller filters the same name in
both packages."""


class FFTuneWarning(UserWarning):
    """The tuning sidecar was unusable and static defaults are in effect."""
