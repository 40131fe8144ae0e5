"""Operations and bytes of the work a step does, from the configuration's
shapes and the rows the step evaluates (the yardstick of ``mfu`` and
``*_roofline``)."""
