"""Operations and bytes of the model and of each kernel's op, from the
configuration's shapes alone: the algorithm's work, whatever implements
it. Products count 2 per multiply-add; bytes count each input read once
and each output written once. A reader divides them by the cell's peaks
(`peaks.json`) for the least time, the larger of the two bounds."""
