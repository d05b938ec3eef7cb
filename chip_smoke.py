#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold each kernel against its plain version.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and a C compiler (for the RLE codec); it
builds the six kernel libraries of ``torchmetrics_tpu_torch/csrc/`` (one
``nvcc`` each, started together). It
exits non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is not beside it.

Phases, one JSON line each; any mismatch raises and the script exits non-zero:

1. ``build``: compile the six kernel libraries (the build line gives each library's
   ``nvcc`` time, kernel count, most registers and largest spill, and, for the
   kernels redesigned for Hopper, each one's registers, spills and shared
   memory), print the card's name and power limit;
2. ``kernel_vs_plain``: the confmat kernel against its plain PyTorch version on the card,
   counts exactly, float32 weights within a stated tolerance;
3. ``imagenet_val``: torchvision's classification evaluation (50,000 samples,
   1000 classes, batches of 1024) through ``MulticlassAccuracy`` top-1/top-5
   and ``MulticlassConfusionMatrix``, half by ``forward``, half by ``update``,
   checked exactly against ``numpy`` on the host;
3a. ``confmat_exact_2p24``: 2**24 + 3 rows, all (1, 1), in one update of
   ``BinaryConfusionMatrix`` and ``MulticlassConfusionMatrix`` at 3 and 300
   classes (B1): exactly 16,777,219 in cell (1, 1);
3b. ``classification_collection``: BASELINE config 2 on the same deployment, a
   ``MetricCollection`` of micro accuracy, macro precision/recall/F1, binned
   (100 thresholds) and exact AUROC and two confusion matrices, half by
   ``forward``, half by ``update``: counts exact against ``numpy``, ratios and
   AUROC (binned against ``numpy`` on the same thresholds, exact against a
   float64 rank sum) within stated tolerances, the compute groups of the CPU
   tests, B1 launched once an ``update`` batch and once a confusion-matrix
   member a ``forward`` batch, results equal to the metrics outside a
   collection; batches/s, update and forward ms, each AUROC's ``compute`` ms,
   peak memory;
3c. ``aggregation``: Mean, Sum, Max, Cat and ``RunningMean(window=5)`` over 49
   batches of losses made on the card, one with NaNs under
   ``nan_strategy="ignore"``, against float64 on the host;
4. ``ade20k_full``: 847-class semantic segmentation, 8 updates of 16 label maps
   of 512x512 with void pixels under ``ignore_index=-1``, checked exactly
   against the plain version on the card;
4a. ``ade20k_miou``: the same maps through one ``MetricCollection`` of the
   confusion matrix, macro and per-class Jaccard (mean IoU), MCC and Cohen's
   kappa: one compute group, B1 once an update (every member once on the
   first, which finds the groups), values against float64 numpy from the
   exact matrix and equal to each metric run alone; mIoU, updates/s, peak memory;
4b. ``classification_rest``: the imagenet_val data through one collection of
   MCC, kappa and Jaccard (B1), specificity and Hamming, average precision
   (100 thresholds and exact), recall at precision 0.5, specificity at
   sensitivity 0.5, ECE and MCE (15 bins) and the hinge loss, each against
   float64 numpy computed in worker processes while the card streams;
   batches/s and each metric's ``compute`` ms;
4c. ``coco_multilabel``: MS-COCO 2014's multilabel evaluation shape (40,504
   images, 80 labels, ~2.9 positive an image, batches of 256): average
   precision exact and binned, precision at recall 0.5, the three ranking
   metrics, exact match, Hamming, Jaccard, MCC and specificity against
   float64 numpy; images/s and ``compute`` ms;
4d. ``dice_fairness``: Dice (150 classes, macro) on SceneParse150-shaped maps,
   counts exact, and the peak memory of its one-hot temporaries;
   ``BinaryFairness``/``BinaryGroupStatRates`` on CelebA's test shape (19,962
   samples) with 2 and 4 groups, counts exact;
5. ``timing``: the confmat kernel at the main path's two shapes, added into a
   state (``queued_ms``) and as a fresh matrix, beside the bytes bound with and
   without the matrix, its plain version and ``torch.bincount``;
6. ``confmat_distributions``: the confmat kernel and the one-atomic-per-row
   design it replaced at one ADE20K-Full update on three label laws (the
   ade20k_full maps, uniform pairs, 16x16-coherent maps), exact, timed;
7. ``conv_epilogue_vs_plain``: kernels B2a (GEMM + bias + ReLU) and B2b
   (bias + ReLU) against their plain versions at every distinct shape of one
   InceptionV3 forward at batch 200, bf16 and float32, plus odd tails;
8. ``lpips_head_vs_plain``: kernel B3 at every tap shape of the alex, vgg and
   squeeze trunks at 256x256, 50 pairs, on float32 and bf16 maps, each call
   repeated for identical bits;
9. ``fid_cifar10_10k``: ``FrechetInceptionDistance(feature=2048)`` over 10,000
   real and 10,000 perturbed uint8 3x32x32 images in updates of 200, launch
   counts exact, the bf16 fused trunk against the float32 unfused one, the
   FID against a float64 host recomputation from the metric's states;
10. ``lpips_pairs``: ``LearnedPerceptualImagePatchSimilarity()`` (alex) over
    1,000 pairs of 3x256x256 images in batches of 50, one batch each of vgg
    and squeeze, launch counts exact, against ``LPIPSNet(unfused=True)``; the
    head stage alone must run B3 5 times and no copy, fill or division kernel.
    Phases 9 and 10 also give one update's device time by kernel
    (``torch.profiler``) and the share of its wall time the card sat idle;
11. ``image_timing``: CUDA-event medians of B2a, B2b and B3 at their main-path
    shapes, beside their bounds, plain versions and library calls, summed over
    one forward (B3 on bf16 maps, float32 beside), and B2a by activation size
    (73x73, 35x35, 17x17, 8x8);
12. ``attention_vs_plain``: kernel B4 (masked attention) against its plain version
    at the path's shapes, (2999, 128, 768)/12 heads of ``compute`` and
    (100, 128, 768) of a ``forward``, with the WMT corpus's ragged masks, at
    L 1, 37 and 509, at hidden 96/4 heads, with fully masked rows, float32
    and bf16; a view that is not 4-element aligned is refused;
13. ``layernorm_residual_vs_plain``: kernel B5 at the path's (383872, 768) and at
    C 70, 1000, 1024 and 2000, float32, bf16 and mixed inputs;
14. ``bertscore_wmt``: ``BERTScore(model=BertEncoderExtractor(npz))`` on seeded
    random bert-base-uncased weights over 2,999 pre-tokenized pairs (the size of
    WMT16 newstest2016 de-en) in updates of 100, half by ``forward``, then
    ``compute``, with ``idf`` off and on: launch counts exact, scores against the
    unfused float32 encoder on the card, one ``compute``'s device time by kernel;
15. ``infolm_pairs``: ``InfoLM`` (KL, idf, temperature 0.25) on the same weights'
    MLM head over 128 pairs of up to 64 wordpieces, launch counts exact, against
    the unfused MLM on the card;
16. ``text_timing``: CUDA-event medians of B4 and B5 at one BERTScore encoder
    forward's shapes, beside their bounds, plain versions and library calls, and
    of B4 on bf16 inputs beside bf16 ``scaled_dot_product_attention``;
17. ``detection_coco_val``: BASELINE config 3, ``MeanAveragePrecision(iou_type="bbox")``
    on a COCO val2017-shaped stream made on the card (5,000 images, 80 classes,
    100 detections and 1-50 ground truths an image, ~1% crowd, updates of 16):
    the 12 summary values against the port's own CPU run of the same updates
    (1e-6) and, on a 500-image subset, against the numpy pycocotools port of
    ``tests/unittests/detection/`` (1e-5); ``class_metrics=True`` on the same
    states; images/s, ``compute`` ms, peak memory, one ``compute``'s device time
    by kernel and idle share. The host references run in worker processes
    while the card works through phases 17-21, and are read at the end;
18. ``detection_segm``: ``iou_type="segm"`` on 100 images of 427x640 masks (20
    detections, 1-10 ground truths each) against the pycocotools port (1e-4),
    and the masks' round trip through ``tm_to_coco``/``coco_to_tm`` and the
    port's C RLE codec, exact;
19. ``detection_stream``: 1,000 updates of 1 image (100 detections, 20 ground
    truths), updates/s, the result equal to one update of all 1,000 images;
20. ``iou_panoptic``: IoU, GIoU, DIoU and CIoU (functional matrices and classes
    with ``class_metrics``) on 16 images of 100 x 100 boxes against float64
    numpy (1e-6); ``PanopticQuality`` and ``ModifiedPanopticQuality`` on 8
    COCO-panoptic-like 512x512 maps, states equal to the CPU run; golden cases
    158-163 replayed on the card;
21. ``text_no_model``: ``BERTScore()`` and ``InfoLM()`` built without a model (the
    hash encoders) on 64 pairs of the bertscore_wmt and infolm_pairs corpora,
    token ids exact and scores within 1e-6 / 1e-5 of the port's CPU run;

the text family without a model (phases 22-27, data from ``--seed``; their
host references run in worker processes while the card works, and B1-B5's
launch counters, set to 0 before them, must read 0 after them):

22. ``librispeech_asr``: LibriSpeech test-clean's shape (2,620 utterances,
    52,576 reference words) through a ``MetricCollection`` of WER, CER, MER,
    WIL, WIP and character ``EditDistance`` in updates of 32, then each
    functional over the whole corpus: counts exact against a plain-Python
    Levenshtein, rates within 1e-6 of float64, WIL and WIP in one compute
    group, the DP route (host or device) of every call; utterances/s;
23. ``cnndm_rouge``: BASELINE config 5 on CNN/DailyMail test's shape (11,490
    pairs): ``ROUGEScore`` (rouge1/2/L/Lsum, ``accumulate="best"``) in updates
    of 64 and ``rouge_score`` over all pairs (the batched LCS on the card),
    against a plain-Python float64 ROUGE and LCS (lengths exact) and, for
    rougeLsum, the port's CPU run; then the config's ``MetricCollection`` of
    ``ROUGEScore`` and ``BERTScore()`` on 1,000 pairs, equal to each alone;
24. ``wmt_mt``: BLEU, SacreBLEU (13a, intl), chrF, chrF++, TER and EED on 2,999
    WMT16-shaped pairs in updates of 100: states exact and scores within 1e-6
    of the port's CPU run of the same updates; each metric's pairs/s;
25. ``perplexity_wikitext``: ``Perplexity(ignore_index=-100)`` at GPT-2's
    vocabulary of 50,257 over 36 updates of (8, 1024) tokens (WikiText-2 test's
    ~287,000), float32 and bf16 logits, within 1e-4 of a float64 log-softmax;
    tokens/s and the peak memory of an update;
26. ``squad_v1``: ``SQuAD()`` over SQuAD v1.1 dev's 10,570 questions, equal to
    the port's CPU run;
27. ``edit_dispatch``: the edit DP's host route (timed in a worker) against its
    batched route on the card, words and characters at 1, 4, 32, 256 and 2,620
    LibriSpeech-shaped pairs: where each is faster, and the route the dispatch
    constant picks;

the rest of image (phases 28-32, data from ``--seed``; the port's CPU runs
that the pan-sharpening and PPL checks read run in worker processes while
the card works; B1, B4 and B5 must not launch, B2a/B2b and B3 launch as
counted):

28. ``generative_cifar10``: ``InceptionScore()`` over 50,000 generated 32x32
    images in updates of 200 (StyleGAN2-ADA's ``is50k``), then a
    ``MetricCollection`` of ``KernelInceptionDistance(subsets=100,
    subset_size=1000)`` and ``MemorizationInformedFrechetInceptionDistance()``
    over 10,000 real and 10,000 generated images, on the bf16 trunk of
    ``fid_cifar10_10k``: one compute group, B2a/B2b launched 40/54 times a
    trunk forward; IS against float64 numpy from its own features under the
    same permutation, KID against float64 on the same 100 subsets, MiFID's
    cosine term against float64 and its FID part against a float64 host
    recomputation; images/s and each ``compute``'s ms;
29. ``ppl_lpips_vgg``: ``PerceptualPathLength()`` at its defaults (10,000
    samples, batches of 128, lerp, epsilon 1e-4, resize 64, LPIPS-VGG: B3
    five times a call) on a seeded 512-latent generator to 3x256x256: mean
    and std against float64 numpy from its distances, the first 256 distances
    against the port's CPU run, and against float32 maps; samples/s;
30. ``div2k_sr``: 100 DIV2K-sized pairs (3x1356x2040) of x4 bicubic
    super-resolution through one collection of PSNR, SSIM, MS-SSIM, UQI and
    VIF in updates of 4: SSIM and MS-SSIM in separate groups, each value
    against float64 windows on the card; pairs/s, an update's ms, the peak
    memory above the inputs;
31. ``image_quality_rest``: total variation and image gradients on 16
    3x512x512 images, PSNR-B on 29 LIVE1-sized Y images with 8x8 block
    offsets, against float64 numpy;
32. ``pansharpening_wv3``: PanCollection WorldView-3-shaped sets, 20
    reduced-resolution 8x256x256 pairs (ERGAS, SAM, SCC, RASE, RMSE-SW, UQI)
    and 20 full-resolution 8x512x512 fused images with MS and PAN (D_lambda,
    D_s, QNR), against the port's CPU run of the same updates; each
    ``compute``'s ms;

then an ``image_rest`` line with B1-B5's launch counts over phases 28-32;

regression, pairwise distances and retrieval (phases 33-38, data drawn on
the card from ``--seed``; none of B1-B5 may launch in them):

33. ``nyu_depth_v2``: NYU Depth v2's Eigen test split (654 depth maps of
    480x640, targets in [0.7, 10] m, predictions the target times
    exp(0.1 N(0, 1))) in updates of 8 through one collection of MSE, RMSE,
    MAE, MSLE, MAPE, log-cosh, R², explained variance, RSE, Minkowski(3)
    and Pearson, against float64 sums of the same pixels; the float32 counts
    exact at 200,908,800;
34. ``stsb_sickr``: STS-B dev (1,500 pairs) and SICK-R test (4,927) with gold
    scores on a 0.2 grid, batches of 32: Pearson, Spearman, concordance and
    Kendall tau-a/b/c with p-values, against ``scipy.stats`` and the JAX
    package's p-value formula in float64, and Pearson after a
    ``merge_state`` of two halves;
35. ``fremtpl2_tweedie``: freMTPL2freq's 678,013 policies (~95% without a
    claim) in updates of 8,192: Tweedie deviance at powers 1.9 and 1, MAE,
    MSE, WMAPE and SMAPE against float64;
36. ``sevir_csi``: 1,024 SEVIR-shaped sequences of 12 VIL frames of 384x384
    in updates of 16: CSI at six thresholds and per sequence at one, hits,
    misses and false alarms exact against int64 bincounts;
37. ``embeddings_pairwise``: cosine, euclidean and linear on 10,000 x 768
    against 10,000 x 768, Manhattan and Minkowski(3) on 2,048 x 2,048 x 768,
    ``CosineSimilarity`` over 50,000 pairs and ``KLDivergence`` of the
    imagenet_val logits' softmax against a seeded teacher's (both
    ``log_prob``), against float64 on 256 sampled rows; TF32's flag must not
    move a product;
38. ``msmarco_dev``: MS MARCO dev's 6,980 queries x 1,000 candidates in
    updates of 100 queries, ~1% of the rows ``ignore_index=-1``: MRR@10,
    nDCG@10, precision@10, hit rate@10, fall-out@10, recall@100 and @1000,
    MAP (``skip``), R-precision and AUROC (``median``) in one collection,
    against plain per-query numpy loops in worker processes;

then a ``regression_retrieval`` line with the seconds of phases 33-38 and
B1-B5's launch counts over them (all 0);

clustering, nominal association and the wrappers (phases 39-43, data drawn
on the card from ``--seed``; B1, B3, B4 and B5 may not launch, B2a/B2b only
in phase 43's trunk forwards):

39. ``clustering_imagenet``: ImageNet-1k val's 50,000 labels against a
    synthetic 1000-cluster assignment (the true class with probability
    0.6), as deep-clustering papers report NMI, AMI and ARI: the 9 extrinsic
    classes in updates of 1,024 against float64 from an int64 contingency
    (1e-5 relative; AMI 1e-5) and a numpy EMI in a worker process; each
    ``compute``'s ms, EMI's terms and ms, the float32 pair counts' error;
40. ``clustering_features``: Calinski-Harabasz, Davies-Bouldin and Dunn on
    the same assignment over 50,000 x 2,048 float32 features, against
    float64 on the card (1e-5); ms and the peak above the inputs;
41. ``nominal_adult``: UCI Adult's 48,842 rows x 9 categorical columns: the
    four association matrices, the four pair classes streamed with and
    without ``num_classes``, both NaN strategies on 1% NaNs, against float64
    numpy (1e-5); ms per matrix;
42. ``fleiss_cifar10h``: Fleiss' kappa on CIFAR-10H's shape (10,000 images,
    10 classes, 51 annotators) as counts and as scores (1e-6);
43. ``wrappers_imagenet_cifar10``: ``BootStrapper(MulticlassAccuracy(1000))``
    on the imagenet_val data, its loop route (10 copies, each equal to its
    own metric on the numpy-drawn indices) and its stacked route (100
    copies, within 1e-6 of a float64 count-weighted accuracy under the
    counts it drew); ``BootStrapper(MulticlassConfusionMatrix(1000))``, 10
    copies, each route forced at batches of 64, 256 and 1,024 (exact
    against numpy; ms a batch and peak memory; the route that
    ``_STACKED_DELTA_BYTES`` picks no more than 1.5x the faster one);
    ``MetricTracker``, ``ClasswiseWrapper``,
    ``MinMaxMetric``, ``MultioutputWrapper`` and ``MultitaskWrapper`` equal
    to their metrics run alone; ``FeatureShare`` over FID, KID and MiFID on
    fid_cifar10_10k's 10,000 + 10,000 images: one trunk forward a batch (B2a
    40 and B2b 54 launches), states bit for bit equal to the three metrics
    run alone; images/s shared and unshared;

then a ``clustering_nominal_wrappers`` line with the seconds of phases
39-43 and B1-B5's launch counts over them;

audio, multimodal and segmentation (phases 44-47, data drawn on the card
from ``--seed``; the float64 SRMR oracle, S1's plain loop at the main
path's shapes, CLIP's CPU run and scipy's distance transforms run in
worker processes while the card works; kernel S1 launches in phase 44
only, B1-B5 in none):

44. ``srmr_reverb``: SRMR at the reference's defaults (16 kHz, 23 cochlear
    filters, 125 Hz, 4-128 Hz bands) over 64 REVERB-shaped 8 s utterances in
    batches of 16, also ``norm=True`` and ``fast=True``; kernel S1
    (``biquad.cu``) in both modes against its plain loop, bit for bit: on
    the card at 2 utterances cut to 1 s (where the plain loop is timed) and
    on the host at the main path's first update (16 utterances, their 368
    gammatone channels, then 2,944 modulation bands, read after phase 47
    as ``srmr_reverb_s1_main_shape`` with how far cuFFT's envelopes lie
    from the CPU's); at full length against float64 ``lfilter``; the scores
    of 4 utterances against a float64 scipy oracle, ``fast=True`` against
    the port's CPU run; S1 exactly 2 launches an update (1 on the fast
    path); utterances/s;
45. ``wsj0_2mix_separation``: WSJ0-2mix test's shape (3,000 mixtures of 2
    speakers, 8 kHz, 32,000 samples, batches of 100): PIT with SI-SNR in both
    modes, SNR, SI-SDR, SA-SDR and C-SI-SNR on a 512-point STFT against
    float64 numpy (the permutations equal to an exhaustive float64 search),
    SDR (512 taps) on 500 mixtures against a float64 Levinson solve; 3 and 8
    speakers (the Hungarian route) against scipy's ``linear_sum_assignment``;
    mixtures/s;
46. ``clipscore_coco_clipiqa_koniq``: ``CLIPScore`` on seeded random
    openai/clip-vit-large-patch14 widths over COCO Karpathy test's pairs
    (480x640 images as floats in [0, 1], captions of 8-77 tokens through
    the script's tokenizer; 2,500 of the 5,000 for time),
    ``CLIPImageQualityAssessment`` with all 16 prompts on
    clip-vit-base-patch16 widths over KonIQ-10k's 1024x768 uint8 images
    (5,000 of the 10,073);
    the first 32 pairs (per pair, and through the metric's state and
    ``compute``) and 16 images against the port's CPU run, the
    random-projection encoder against its CPU run; pairs/s, images/s and the
    trunk's share of an update;
47. ``segmentation_brats_kits``: ``mask_edges`` with spacing on 8
    BraTS-shaped 240x240x155 volume pairs (codes exact, areas against float64
    numpy), ``distance_transform`` (three metrics) and ``surface_distance`` on
    64 KiTS19-shaped 512x512 slices against ``scipy.ndimage``; tile rows and
    peak memory;

then an ``audio_multimodal_segmentation`` line with the seconds of phases
44-47 and the launch counts, then

48. ``compiled_path``: the compiled update path (CUDA graphs, one a
    signature) against ``auto_compile=False``: the imagenet_val data through
    a collection of macro accuracy and the 1,000-class confusion matrix,
    Jaccard and MCC (one compute group, B1 in its head's graph) beside a
    mean cross-entropy, states and results bit for bit, B1's launches equal,
    the replays under ``torch.cuda.set_sync_debug_mode("error")``; the 16
    default-path classes at 32 and 65,536 rows; ``jit_update`` and
    ``scan_update``; a deferred violation; a ring buffer past its capacity
    (``--phase compiled_path`` runs the build and this phase alone;
    ``--phase compiled_stream --order compiled,eager,traced`` runs the build
    and then whole imagenet_val streams in that order, each with its host
    milliseconds by kind of batch, ``traced`` under ``torch.profiler`` with
    its top host rows);

49. ``captured_trunks``: the trunk metrics by default (compiled where the
    JAX runtime compiles them) against ``auto_compile=False``: FID
    (InceptionV3 2048, bf16, batches of 200), IS and KID with a ring
    capacity, LPIPS alex, CLIPScore (ViT-B/16), BERTScore (bert-base) and
    SRMR (16 x 8 s at 16 kHz); the routing of the JAX runtime, states and
    ``compute()`` bit for bit, B2a-B5 and S1 launched from graph replays as
    often as on the other route, replays under the sync guard, the trunks'
    graphs and pool bytes, host ms an update and the rates on each route
    (``--phase captured_trunks`` runs the build and this phase alone);

50. ``observability``: the runtime telemetry (``_observability``) on the
    card. The compiled imagenet_val collection of phase 48 for 100 updates
    with every switch off (no telemetry object, no span, no ledger entry, B1
    once an update) and again with telemetry, tracing and profiling on (the
    counters the routes imply, one span a call, a Chrome trace that parses,
    and the ledger's CUDA-event device seconds within 10% of an outer event
    pair around the same updates, queued behind a sleep so the card runs
    them back to back), the host ms an update each way; 10 compiled FID
    batches of 200 with their counted flops an image and the MFU gauge; a
    flight dump of an ``auto_path_disabled`` event (``--phase
    observability`` runs the build and this phase alone);

51. ``resilience``: the resilience runtime (``_resilience``) on the
    imagenet_val data through BASELINE config 2's collection (macro
    accuracy, precision, recall, F1, binned AUROC, the 1,000-class confusion
    matrix on B1, a NaN-sensitive mean cross-entropy and ECE): batches 5, 17
    and 33 NaN-poisoned under ``nan_policy="quarantine"``, a snapshot
    manager journaling every update, a preemption after 29 updates and a
    restore, bit for bit with an uninterrupted stream, eager and on the
    compiled path; a corrupted ``cm`` state refused and repaired; a retried
    and a degraded guarded sync in a simulated world, a one-rank NCCL
    guarded sync in a spawned child; the chaos smoke schedules on the card
    (``--phase resilience`` runs the build and this phase alone);

52. ``stream_pool``: multi-tenant stream pools (``_streams``) through
    ``to_stream_pool``: a 1,000-class ``MulticlassConfusionMatrix`` pool of
    128 tenants growing to 256 (one doubling), 196 vmapped micro-batches of
    64 tenants x 1,024 labels (50,000 a tenant), each one CUDA graph replay
    with B1 counting its 64 lanes in one launch (``confmat_lanes``), with
    reset and detach/attach churn and a label outside [0, C); every
    tenant's matrix bit for bit against numpy, 8 against eager twins, the
    journal's ``restore_stream`` of two tenants and ``restore_latest`` bit
    for bit; a 64-tenant pool of the collection's stat-score members
    against eager twins; host and device ms a step, ``compute_all`` ms, the
    lane-batched kernel's ``queued_ms`` beside its bound and the lanes'
    gather and scatter (``--phase stream_pool`` runs the build and this
    phase alone);

53. ``trunk_pools``: the trunk metrics the JAX package pools, through
    ``to_stream_pool``: FID (InceptionV3 2048, 16 tenants, micro-batches of
    8 lanes x 25 CIFAR-10-sized images, real and fake alternating), LPIPS
    alex (8 lanes x 8 pairs of 256x256), CLIPScore ViT-B/16 (8 lanes x 8
    images, one caption list a micro-batch) and SRMR (8 lanes x 2 reverberant
    8 s utterances at 16 kHz); ``warm_start`` for each key, then each
    micro-batch one CUDA graph replay whose trunk forward runs inline, each
    trunk kernel launched once a micro-batch through its wrapper's vmap rule
    (a step launches what one forward launches); every tenant's states and
    ``compute(i)`` against an eager twin, FID's ``compute_all`` raising, the
    pool graphs' bytes against ``_compile._pool_bound``, host and device ms a
    step against the eager twins' for the same images; each lane-batched
    launch at the folded shapes against its plain version and a launch a lane,
    its ``queued_ms`` beside its bound (``--phase trunk_pools`` runs the build
    and this phase alone);

54. ``spmd_collection``: the SPMD engine (``_spmd``) through
    ``MetricCollection.to_spmd``: BASELINE config 2's in-graph members (macro
    accuracy and F1, the 1,000-class confusion matrix, MCC and Jaccard; AUROC
    is certified host-bound and refused) on a mesh of 8 rows on the card, the
    imagenet_val data in global batches of 1,024 (8 x 128, the last of 848);
    every step against the eager stream (the matrix bit for bit), B1 across
    the rows once a step, two CUDA graphs and every later step a replay; the
    default mesh (every visible card); replica groups; an injected step
    failure and a snapshot restore, each bit for bit with the uninterrupted
    stream; LPIPS alex through the engine (B3 once a tap a step); host and
    device ms a step against the eager stream, kernels a step, graph memory,
    and B1 and B3 across the 8 rows beside their bounds (``--phase
    spmd_collection`` runs the build and this phase alone);

55. ``metric_server``: the serving runtime (``_serving``): a
    ``MetricServer`` over phase 52's 1,000-class confusion-matrix pool, 256
    tenants of 50,000 labels in requests of 1,024 rows (the last of 848),
    12,544 requests from 8 client threads with one request a tenant in
    flight, after ``warm`` (a CUDA graph a bucket, 1 to 64 lanes); every ack
    acked, every tenant's ``compute(i)`` bit for bit against numpy, B1 across
    lanes once a micro-batch, every warmed key replayed, a ``compute(i)``
    from a client thread while the worker captures an 848-row bucket; a
    burst into a queue of 8 (rejected with retry hints), a shed episode
    (one canary admitted), a preemption and recovery from the journal, each
    bit for bit with the acked rows; requests, micro-batches, live rows a
    micro-batch, host and device ms a micro-batch, ack latency, the first
    request after ``warm`` against the steady p99, rows/s, graphs and their
    bytes (``--phase metric_server`` runs the build and this phase alone);

56. ``fleet_rollup``: fleet aggregation (``_fleet``): a ``FleetTree`` of
    ``MulticlassConfusionMatrix(num_classes=1000)`` on the card,
    ``branching=(8, 8)`` (1 global node, 8 regions, 64 edges) over
    ``InProcessKV``, 4 epochs of 2 updates of 1,024 labels an edge, then
    ``run_epoch`` and ``join_pending``; the root and every region bit for bit
    against numpy, every rollup full, 256 sources at the root, every node's
    states on the card and every contribution host values only, B1 exactly
    512 (one an edge update, none in a rollup) with one capture an edge, no
    publisher thread left; a clone of a captured template; ``run_fleet_chaos``
    at ``branching=(4, 4)`` on the card; an exhausted asynchronous publish
    while another edge captures; a ``(2, 2)`` tree over a ``TCPStore`` bit
    for bit with ``InProcessKV``; host ms to encode and to decode and fold a
    contribution, wire bytes an epoch, ms an epoch a level, the root's
    staleness and the peak card memory (``--phase fleet_rollup`` runs the
    build and this phase alone);

57. ``aot_cold_start``: the AOT cache (``_aot``): three child processes, each
    with a fresh kernel build directory and one cache directory, resolve the
    six CUDA libraries, run ``MulticlassConfusionMatrix(num_classes=1000)``
    (``precompile``, then 3 updates of 1,024 labels), a 64-lane stream pool
    of it (``warm_start``, 2 steps) and an 8-row SPMD engine of it
    (``warm_start``, 2 steps), and launch B2a, B2b, B3, B4, B5 and S1 once
    each at a small shape against their plain versions: ``cold`` (an empty
    cache: six ``nvcc`` builds stored), ``warm`` (no ``nvcc`` on ``PATH``,
    ``CUDA_HOME`` empty: every library from the cache, a hit for the metric,
    the pool and the engine), ``damaged`` (a byte of the ``confmat``
    library's artifact flipped and the metric's record truncated: both fall
    back, are rebuilt and rewritten); states and values bit for bit against
    numpy and across the children, B1 launches as the updates imply; each
    child's seconds to its first replay, split into library resolution,
    CUDA init, warm-up and capture, and each artifact's bytes (``--phase
    aot_cold_start`` runs the build and this phase alone);

58. ``spmd_process_group``: the SPMD engine over a mesh that spans a
    process group (one process a card), on a world-1 NCCL group made at the
    phase's start and destroyed at its end: phase 54's main path on 8 rows
    under the group, every step bit for bit with the plain 8-row mesh, B1
    across the rows once a step, one graph a key and every later step a
    replay, the collectives each key's graph captured (one all-reduce a key
    for config 2's integer sums); all-gathers captured for floating sums and
    Pearson's moments, and a ``CatMetric`` ring, bit for bit; one replay
    under the profiler beside the plain mesh's; replica groups, an injected
    failure and a snapshot restore, bit for bit; LPIPS alex through the
    engine (B3 once a tap a step); ``build_mesh()`` under the group; a mesh
    on the card over a gloo group refused; host and device ms a step
    against the plain mesh (``--phase spmd_process_group`` runs the build
    and this phase alone);

the card's name and power limit, the
``kernels`` line (B1, B1 across lanes, B2a-B5 and S1, and B2a-B5 and S1
across lanes; the lane rows count phase 54's and phase 58's steps and
phase 55's micro-batches too) and, last,
``{"ok": true, "device": {...}}``. Trunk weights are seeded random ones: no
checkpoint can be downloaded. Floats are printed to 7 significant digits.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import hashlib
import importlib
import json
import os
import re
import shutil
import socket
import statistics
import multiprocessing
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FLOAT_RTOL = 1e-4  # float32 cell sums of up to ~1000 weights: the kernel's atomics vs the plain float64 bincount
FLOAT_ATOL = 1e-4
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores: B2b's and B3's arithmetic
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak: B4's float32 products, three passes (3xTF32)
GEMM_F32_RTOL = 1e-5  # of the output's scale: float32 sums of up to 2048 products, in another order
GEMM_BF16_ULP = 2.0**-7  # of each value: the float32 sums differ, so one bf16 rounding may flip
HEAD_RTOL = 1e-5  # the JAX package's own tolerance for the LPIPS head
TRUNK_F32_RTOL = 1e-3  # fused (kernels) vs unfused float32 trunk, by relative norm; the chaos below grows f32 roundings too
# bf16 fused trunk vs float32 unfused trunk, by relative norm. With calibrated BatchNorm a random
# InceptionV3 is chaotic: BN + ReLU grows a relative perturbation ~1.2x per layer, so bf16's 2**-9
# roundings reach ~0.2 at the 2048 tap. Wrong weights or a wrong layout give ~1.
TRUNK_BF16_RTOL = 0.5
FID_RTOL = 1e-2  # the metric's float32 FID vs a float64 host recomputation from its own states
ATT_F32_RTOL = 1e-5  # of the output's scale: float32 sums of L*d products and L exps, in another order
ATT_BF16_ULP = 2.0**-7  # of each value: kernel and plain both round one float32 value to bf16, which may flip
LN_RTOL = 1e-5  # of the output's scale: float32 row sums in another order, rsqrtf within 2 ulp
# fused (B4/B5) vs unfused float32 encoder: hidden states agree to ~1e-6 relative, and
# precision/recall/F1 are weighted means of cosines in [-1, 1]
BERTSCORE_ATOL = 1e-4
# InfoLM KL per sentence, fused vs unfused float32 MLM: logits ~1e-6 apart, divided by the 0.25 temperature
INFOLM_RTOL, INFOLM_ATOL = 1e-4, 1e-5
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                 max_position=512, type_vocab=2)  # bert-base-uncased's published config
SPECIAL_IDS = {"pad_token_id": 0, "cls_token_id": 101, "sep_token_id": 102, "mask_token_id": 103}  # its vocab's
# classification_collection: macro precision/recall/F1 and the normalized confusion matrix against float64 numpy
# (float32 divisions and a 1000-term float32 mean); binned AUROC against numpy on the same thresholds (float32
# rates and a 100-step trapezoid); exact AUROC against a float64 Mann-Whitney rank sum, ties averaged
COLLECTION_RATIO_ATOL = 1e-6
BINNED_AUROC_ATOL = 1e-6
EXACT_AUROC_ATOL = 1e-5
AGG_RTOL = 1e-6  # aggregation: float32 sums of 16 and 49 positive terms against float64
# the rest of classification against float64 numpy on the host. Ratios in [0, 1] of exact integer counts (IoU,
# specificity, Hamming, binned curves, the operating points, Dice, fairness rates): one float32 division and a
# float32 mean
SLICE6_ATOL = 1e-6
MCC_KAPPA_RTOL = 1e-5  # ade20k_miou: float32 products of ~3e7-pixel sums (s**2 ~ 9e14) and 847-term dot products
EXACT_AP_ATOL = 1e-5  # exact AP against a float64 sort and cumulative sum: float32 precision at each positive
# ECE/MCE: float32 per-bin sums (``index_add_``), whose order of adds on the card varies from run to run. The top
# bin holds ~38,000 confidences just under 1: added one after another in float32 (a resolution of ~4e-3 past
# 2**15) each would round up, ~5e-5 of the bin's mean in all; the card's adds were measured 2.4e-7 off float64
# on an H100
CALIBRATION_ATOL = 2e-5
SUM_RTOL = 1e-5  # the hinge and ranking means: float32 running sums over 40,000-50,000 samples against float64


def _float32_digits(obj):
    """Floats to 7 significant digits, a float32's precision: CUDA events and the kernels' outputs are float32."""
    if isinstance(obj, float):
        return float(f"{obj:.7g}")
    if isinstance(obj, dict):
        return {k: _float32_digits(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_float32_digits(v) for v in obj]
    return obj


def emit(obj: dict) -> None:
    print(json.dumps(_float32_digits(obj)), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` calls of ``fn``, each bracketed by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for start, end in zip(starts, ends):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def queued_ms(torch, fn, reps: int = 30, warmup: int = 3, launches: int = 1) -> float:
    """Median device time of ``fn`` with the host's launches queued ahead of the card.

    A spin kernel (``torch.cuda._sleep``) holds the stream while every call
    and its two events are enqueued, so each pair of events brackets the
    kernels alone: for a call shorter than its host-side launch cost,
    :func:`median_ms` measures the host instead. ``launches``: the wrapper
    calls in one ``fn``, each given the spin's host allowance.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(reps * launches * 2e5))  # ~0.1 ms a call at the H100's clock: more than a wrapper's host cost
    for start, end in zip(starts, ends):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def wall_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of ``fn`` followed by a device synchronize: what one call costs its caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ptxas_summary(log: str) -> dict:
    """Kernel count, most registers and largest spill of one library, from ``nvcc -Xptxas -v``'s log."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0), "max_spill_bytes": max(spills, default=0)}


def ptxas_templates(log: str, name: str) -> dict:
    """Registers, spill bytes and static shared memory of each instantiation of kernel template ``name``, from ptxas -v.

    Keys are ``name<args>`` with the template arguments read from the mangled
    name: ``f`` float32, ``i``/``l`` int32/int64 labels, ``Bf16`` bf16, ``Li<n>E`` n.
    """
    names = {"f": "f32", "i": "i32", "l": "i64"}
    found, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            args = re.search(name + r"I(.*?)EEv", entry.group(1))
            key = None
            if args:
                tokens = re.findall(r"Li(\d+)E|N\S*?4Bf16E|([fil])", args.group(1) + "E")
                key = f"{name}<{','.join(num or names.get(tag, 'bf16') for num, tag in tokens)}>"
            continue
        if key is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if spill:
                found.setdefault(key, {})["spill_bytes"] = int(spill.group(1))
            if regs:
                found.setdefault(key, {})["registers"] = int(regs.group(1))
                found[key]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return found


def bound_ms(cost, flops_per_s: float):
    """The least time for a call's work: the larger of its operations over peak and its bytes over HBM rate."""
    t_ops = cost.flops / flops_per_s * 1e3
    t_bytes = cost.bytes_accessed / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def rel_norm(torch, got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double()) / torch.linalg.vector_norm(want.double()))


def device_time_by_kernel(torch, fn, top: int = 10, counted=None) -> dict:
    """Device time of one call of ``fn`` by kernel (``torch.profiler``), and the share of its wall time the card idled.

    Only the device rows count: the row of a PyTorch op repeats the time of
    the kernels it launched. The wall time is taken under the profiler.
    ``counted``, a ``(kernel name, launch counter)`` pair, adds the calls of
    that kernel the profiler saw beside the counter's increase over the same call.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = None if counted is None else int(counted[1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.key, evt.self_device_time_total / 1e3, evt.count) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    out = {  # no rows: the profiler saw no device time here, and the CUDA-event timings stand alone
        "wall_ms": wall, "device_busy_ms": busy if rows else None, "launches": sum(r[2] for r in rows),
        "idle_share": 1.0 - busy / wall if rows else None, "kernels": len(rows),
        "top": [{"kernel": name[:64], "ms": ms, "calls": calls} for name, ms, calls in rows[:top]],
    }
    if counted is not None:
        out["counted"] = {"kernel": counted[0], "counter": int(counted[1]) - before,
                          "profiler_calls": sum(calls for name, _, calls in rows if counted[0] in name)}
    return out


def inception_npz(torch, np, seed: int, folder: str, dev, gen) -> str:
    """Seeded random InceptionV3 weights as the JAX package's ``.npz``, with BatchNorm made non-trivial.

    Kernels are drawn with the flax laws and the BN scales and shifts from
    the seed. The running statistics are calibrated, as a trained network's
    are: each BatchNorm takes the mean and variance of what reaches it in one
    float32 forward over 64 seeded images. Drawn at random instead, they leave
    activations shrinking layer by layer, and the pooled features' covariance
    so ill-conditioned that float32 statistics no longer resolve it.
    """
    from torchmetrics_tpu_torch.image._inception import InceptionV3, _BatchNorm, _resize_bilinear_tf1, init_weights_
    from torchmetrics_tpu_torch.utilities.compute import full_fp32
    from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, variables_from_state_dict

    net = init_weights_(build_on_cpu(InceptionV3, fuse_bn=False), seed)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, value in net.state_dict().items():  # shares storage with the module
            if name.endswith("BatchNorm_0.weight"):
                value.uniform_(0.5, 1.5, generator=cpu_gen)
            elif name.endswith("BatchNorm_0.bias"):
                value.normal_(0.0, 0.1, generator=cpu_gen)

    def calibrate(module, args):
        y = args[0].float()
        module.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        module.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))

    net = net.to(device=dev, memory_format=torch.channels_last)
    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules() if isinstance(m, _BatchNorm)]
    imgs = torch.randint(0, 256, (64, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    x = ((_resize_bilinear_tf1(imgs.float(), 299, 299) - 128.0) / 128.0).contiguous(memory_format=torch.channels_last)
    try:
        with torch.no_grad(), full_fp32():
            net(x, "2048")
    finally:
        for hook in hooks:
            hook.remove()
    path = os.path.join(folder, "inception.npz")
    np.savez(path, **variables_from_state_dict(net.cpu().state_dict()))
    return path


def inception_conv_calls(extractor, imgs) -> list:
    """``(x shape, weight shape, stride, padding, out shape)`` of every conv of one forward, in order."""
    from torchmetrics_tpu_torch.image._inception import BasicConv2d

    calls = []

    def record(mod, args, out):
        conv = mod.Conv_0
        calls.append((tuple(args[0].shape), tuple(conv.weight.shape), conv.stride, conv.padding, tuple(out.shape)))

    hooks = [m.register_forward_hook(record) for m in extractor.net.modules() if isinstance(m, BasicConv2d)]
    try:
        extractor(imgs)  # the shape's first call: eager, so each conv's hook fires once
    finally:
        for hook in hooks:
            hook.remove()
    return calls


def is_pointwise(call) -> bool:
    _, wshape, stride, padding, _ = call
    return wshape[2:] == (1, 1) and tuple(stride) == (1, 1) and tuple(padding) == (0, 0)


def gemm_shape(call):
    (n, cin, h, w), (cout, _, _, _), _, _, _ = call
    return (n * h * w, cin, cout)


def rows_shape(call):
    n, c, h, w = call[4]
    return (n * h * w, c)


def phase_conv_epilogue_vs_plain(torch, ce, calls, dev, gen) -> dict:
    pointwise = sorted({gemm_shape(c) for c in calls if is_pointwise(c)})
    spatial = sorted({rows_shape(c) for c in calls if not is_pointwise(c)})
    # odd tails: element path (K or N not a multiple of 8) and the TMA path with ragged M, K and N
    tails = [(1001, 70, 33), (129, 8, 5), (77, 1280, 447), (3, 3, 7), (1001, 64, 40), (77, 1288, 72)]
    cases, worst = [], {"mm_abs": 0.0, "mm_rel": 0.0, "br_abs": 0.0}
    for m, k, n in pointwise + tails:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=dev).relu_().to(dtype)  # activations are post-ReLU
            w = (torch.randn((n, k), generator=gen, device=dev) / k**0.5).to(dtype)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            got = ce.matmul_bias_relu(x, w, b)
            ref = ce.matmul_bias_relu_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            if dtype == torch.float32:
                ok = float(err.max()) <= GEMM_F32_RTOL * scale
            else:
                ok = bool((err <= GEMM_BF16_ULP * ref.float().abs() + GEMM_F32_RTOL * scale).all())
            name = f"B2a ({m},{k},{n}) {str(dtype).split('.')[-1]}"
            check(ok, f"{name}: max abs err {float(err.max())} at output scale {scale}")
            worst["mm_abs"] = max(worst["mm_abs"], float(err.max()))
            worst["mm_rel"] = max(worst["mm_rel"], float(err.max()) / max(scale, 1e-30))
            cases.append({"case": name, "max_abs_err": float(err.max()), "scale": scale})
    for m, c in spatial + [(1001, 33), (77, 5)]:
        for dtype in (torch.bfloat16, torch.float32):
            y = torch.randn((m, c), generator=gen, device=dev).to(dtype)
            b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
            ref = ce.bias_relu_plain(y, b)
            got = ce.bias_relu_(y.clone(), b)
            torch.cuda.synchronize()
            name = f"B2b ({m},{c}) {str(dtype).split('.')[-1]}"
            err = float((got.float() - ref.float()).abs().max())
            check(torch.equal(got, ref), f"{name}: max abs err {err}, expected exact")
            worst["br_abs"] = max(worst["br_abs"], err)
            cases.append({"case": name, "max_abs_err": err})
    emit({
        "phase": "conv_epilogue_vs_plain", "cases": len(cases), "pointwise_shapes": len(pointwise),
        "spatial_shapes": len(spatial), "worst": worst,
        "tolerance": {
            "B2a_float32": f"max|err| <= {GEMM_F32_RTOL} * max|ref|",
            "B2a_bfloat16": f"|err| <= 2**-7 * |ref| + {GEMM_F32_RTOL} * max|ref| (one bf16 rounding step)",
            "B2b": "exact (same float32 add and one rounding)",
        },
    })
    return {"cases": cases, "worst": worst, "pointwise": pointwise, "spatial": spatial}


def label_maps(torch, dev, gen, kind: str, classes: int = 847, maps: int = 16, side: int = 512):
    """One ADE20K-Full update's ``(preds, target, valid)`` (16 maps of 512x512), formatted as the metric does.

    ``ade20k``: the ade20k_full phase's law (10% void, 70% of the rest right,
    pixels i.i.d.); ``uniform``: i.i.d. pairs, no void; ``coherent``: each
    label constant over 16x16 patches, 70% of the patches right, as real
    segmentation maps are spatially coherent.
    """
    n = maps * side * side
    draw = lambda shape: torch.randint(0, classes, shape, generator=gen, device=dev)  # noqa: E731
    if kind == "ade20k":
        t = draw((n,))
        void = torch.rand(n, generator=gen, device=dev) < 0.10
        t[void] = -1
        right = (torch.rand(n, generator=gen, device=dev) < 0.70) & ~void
        p = torch.where(right, t, draw((n,)))
    elif kind == "uniform":
        t, p = draw((n,)), draw((n,))
    else:
        patches = (maps, side // 16, side // 16)
        tp = draw(patches)
        pp = torch.where(torch.rand(patches, generator=gen, device=dev) < 0.70, tp, draw(patches))
        t, p = (x.repeat_interleave(16, 1).repeat_interleave(16, 2).reshape(-1) for x in (tp, pp))
    valid = t != -1
    return torch.where(valid, p, 0), torch.where(valid, t, 0), valid


def phase_confmat_distributions(torch, kernel, dev, gen) -> dict:
    """B1 and the one-atomic-per-row design it replaced, at one ADE20K-Full update on three label laws.

    Both add into a state; both must equal the plain version exactly (the new
    kernel over two calls into one matrix). The old kernel's times across the
    laws show what set its pace; the new one's, how far it still depends on the data.
    """
    lib, c = kernel._library(), 847
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def row_atomics(p, t, valid, out):  # the replaced kernel's own launch: 256 threads, up to 8 blocks an SM
        n = p.numel()
        err = lib.tm_confmat_row_atomics(p.data_ptr(), t.data_ptr(), valid.data_ptr(), n, c, 1, 1, 0, out.data_ptr(),
                                         min(8 * sms, -(-n // 256)), torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"row-atomics baseline launch failed: {err}")

    laws = {}
    for kind in ("ade20k", "uniform", "coherent"):
        p, t, valid = label_maps(torch, dev, gen, kind, c)
        ref = kernel.confusion_matrix_plain(p, t, c, valid)
        state, old = torch.zeros_like(ref), torch.zeros_like(ref)
        for _ in range(2):
            kernel.confusion_matrix_cuda(p, t, c, valid, out=state)
        row_atomics(p, t, valid, old)
        torch.cuda.synchronize()
        check(torch.equal(state, 2 * ref), f"B1 {kind}: two calls with out= != twice the plain version")
        check(torch.equal(old, ref), f"B1 row-atomics baseline {kind} != plain version")
        laws[kind] = {
            "diagonal_share": float(ref.diagonal().sum() / ref.sum()),
            "ms": queued_ms(torch, lambda: kernel.confusion_matrix_cuda(p, t, c, valid, out=state), reps=50),
            "old_ms": queued_ms(torch, lambda: row_atomics(p, t, valid, state), reps=50),
        }
        del p, t, valid
    n = 16 * 512 * 512
    emit({"phase": "confmat_distributions", "n": n, "classes": c, "labels": "int64 + bool mask", "laws": laws,
          "bound_ms": n * 17 / HBM_BYTES_PER_S * 1e3, "check": "exact, two calls with out= and the baseline",
          "ms": "queued_ms into a state; old_ms: the one-atomic-per-row kernel"})
    return laws


def phase_confmat_exact_2p24(torch, kernel, dev) -> int:
    """2**24 + 3 rows, all (1, 1), in one update: every confusion matrix must hold exactly 16,777,219 in cell (1, 1).

    Binary and 3 classes take the integer ``bincount`` route, 300 classes
    kernel B1; a float32 count would round there. Returns B1's launches.
    """
    from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix, MulticlassConfusionMatrix

    n = 2**24 + 3
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    kernel.confusion_matrix_cuda.launches.reset()
    cells = {}
    for name, metric in (("binary", BinaryConfusionMatrix()), ("multiclass_3", MulticlassConfusionMatrix(num_classes=3)),
                         ("multiclass_300", MulticlassConfusionMatrix(num_classes=300))):
        metric.update(ones, ones)
        cm = metric.compute()
        check(cm.device == dev and cm.dtype == torch.int32, f"{name}: {cm.device} {cm.dtype}")
        cells[name] = int(cm[1, 1])
        check(cells[name] == n == 16_777_219 and int(cm.sum()) == n, f"{name}: cell (1, 1) {cells[name]} != {n}")
    launches = int(kernel.confusion_matrix_cuda.launches)
    check(launches == 1, f"B1 launches {launches} != 1 (the 300-class update)")
    emit({"phase": "confmat_exact_2p24", "rows": n, "cell_1_1": cells, "confmat_launches": launches,
          "check": "exact: 16,777,219 in cell (1, 1)"})
    return launches


def _host_binned_auroc(probs, target, thresholds):
    """Macro AUROC of (T, C) binned counts in float64: a score counts at a threshold it reaches (>=)."""
    import numpy as np

    n, c = probs.shape
    sorted_cols = np.sort(probs, axis=0)
    tpr, fpr = np.empty((len(thresholds), c)), np.empty((len(thresholds), c))
    for k in range(c):
        pos = np.sort(probs[target == k, k])
        above_all = n - np.searchsorted(sorted_cols[:, k], thresholds, side="left")
        tp = len(pos) - np.searchsorted(pos, thresholds, side="left")
        fp = above_all - tp
        tpr[:, k] = tp / len(pos) if len(pos) else 0.0
        fpr[:, k] = fp / (n - len(pos)) if n - len(pos) else 0.0
    tpr, fpr = tpr[::-1], fpr[::-1]  # thresholds descending: the ROC runs from (0, 0) up
    areas = ((tpr[1:] + tpr[:-1]) / 2 * np.diff(fpr, axis=0)).sum(0)
    return float(areas.mean())


def _host_rank_sum_aurocs(probs, target, first_class: int):
    """Per-class AUROC of the columns ``probs[:, j]`` (class ``first_class + j``) as the Mann-Whitney statistic:
    float64 ranks, ties averaged (``scipy.stats.rankdata``)."""
    import numpy as np
    from scipy.stats import rankdata

    ranks = rankdata(probs.astype(np.float64), axis=0)
    areas = []
    for j in range(probs.shape[1]):
        pos = target == first_class + j
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        areas.append((ranks[pos, j].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    return areas


def phase_classification_collection(torch, np, kernel, dev, gen, smi: str, n_val: int = 50_000, c: int = 1000,
                                    batch: int = 1024) -> dict:
    """BASELINE config 2 on imagenet_val: a ``MetricCollection`` of accuracy, precision, recall, F1, binned and
    exact AUROC and two confusion matrices over 50,000 samples of 1000 classes, batches of 1024, half by
    ``forward``, half by ``update``. Checked against the host, the same metrics outside a collection, the
    compute groups of the CPU tests and B1's launch count. Returns the phase's numbers and B1's launches.
    """
    import torchmetrics_tpu_torch as tt

    n_thresholds = 100

    def members():
        return {
            "acc": tt.MulticlassAccuracy(num_classes=c, average="micro"),
            "precision": tt.MulticlassPrecision(num_classes=c),
            "recall": tt.MulticlassRecall(num_classes=c),
            "f1": tt.MulticlassF1Score(num_classes=c),
            "auroc_binned": tt.MulticlassAUROC(num_classes=c, thresholds=n_thresholds),
            "auroc_exact": tt.MulticlassAUROC(num_classes=c),
            "cm": tt.MulticlassConfusionMatrix(num_classes=c),
            "cm_true": tt.MulticlassConfusionMatrix(num_classes=c, normalize="true"),
        }

    logits = torch.randn((n_val, c), generator=gen, device=dev)
    target = torch.randint(0, c, (n_val,), generator=gen, device=dev)
    hit = torch.rand(n_val, generator=gen, device=dev) < 0.76
    logits[torch.arange(n_val, device=dev)[hit], target[hit]] += 10.0
    starts = list(range(0, n_val, batch))
    mc = tt.MetricCollection(members())
    check(all(m.device == dev for m in mc.values()), "a member's states are not on the card")
    # the metrics' own probabilities (the same softmax on the same batch shapes), for the host references,
    # which run in worker processes on the host's other cores while the card streams
    probs = torch.cat([torch.softmax(logits[s:s + batch], dim=1) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["auroc_binned"].thresholds.cpu().numpy()
    step = -(-c // 4)  # four workers, a quarter of the classes each
    chunks = [(lo, min(lo + step, c)) for lo in range(0, c, step)]
    with ProcessPoolExecutor(max_workers=len(chunks), mp_context=multiprocessing.get_context("spawn")) as pool:
        rank_sum_parts = [pool.submit(_host_rank_sum_aurocs, probs[:, lo:hi], host_t, lo) for lo, hi in chunks]
        binned_future = pool.submit(_host_binned_auroc, probs, host_t, thresholds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.confusion_matrix_cuda.launches.reset()
        call_ms = {"forward": [], "update": []}
        t0 = time.perf_counter()
        for b, start in enumerate(starts):
            p, t = logits[start:start + batch], target[start:start + batch]
            t_call = time.perf_counter()
            if b % 2 == 0:
                mc(p, t)
            else:
                mc.update(p, t)
            torch.cuda.synchronize()
            call_ms["forward" if b % 2 == 0 else "update"].append((time.perf_counter() - t_call) * 1e3)
        stream_s = time.perf_counter() - t0
        launches = int(kernel.confusion_matrix_cuda.launches)
        n_forward = len(call_ms["forward"])
        compute_ms = {}
        for name in ("auroc_binned", "auroc_exact"):
            t0 = time.perf_counter()
            mc[name].compute()
            torch.cuda.synchronize()
            compute_ms[name] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = mc.compute()
        torch.cuda.synchronize()
        compute_ms["collection_rest"] = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        # the same metrics outside a collection, by update only: identical states, so identical results
        alone = members()
        for start in starts:
            for m in alone.values():
                m.update(logits[start:start + batch], target[start:start + batch])
        for name, m in alone.items():
            check(torch.equal(m.compute(), res[name]), f"{name}: collection result != the metric outside a collection")
        exact_ref = float(np.mean([area for part in rank_sum_parts for area in part.result()]))
        binned_ref = binned_future.result()
    n_update = len(starts) - n_forward
    expected_groups = {0: ["acc", "f1", "precision", "recall"], 1: ["auroc_binned"], 2: ["auroc_exact"],
                       3: ["cm", "cm_true"]}
    check(mc.compute_groups == expected_groups, f"compute groups {mc.compute_groups}")
    check(launches == n_update + 2 * n_forward,
          f"B1 launches {launches} != {n_update} updates (group head) + 2 x {n_forward} forwards")
    check(all(v.device == dev for v in res.values()), "a result left the card")

    # host references: counts and ratios from numpy, AUROC in float64 on the metrics' own probabilities
    pred1 = probs.argmax(1)
    cm_ref = np.bincount(host_t * c + pred1, minlength=c * c).reshape(c, c)
    check(np.array_equal(res["cm"].cpu().numpy(), cm_ref), "confusion matrix != host bincount")
    tp = np.diag(cm_ref).astype(np.float64)
    fp, fn = cm_ref.sum(0) - tp, cm_ref.sum(1) - tp
    head = mc._modules["acc"]
    for state, want in (("tp", tp), ("fp", fp), ("fn", fn)):
        check(np.array_equal(getattr(head, state).cpu().numpy(), want), f"stat-scores {state} != host")
    check(float(res["acc"]) == float(np.float32(tp.sum()) / np.float32(n_val)), "micro accuracy != host")
    present = (tp + fp + fn) > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        macro = {
            "precision": np.where(tp + fp > 0, tp / (tp + fp), 0.0),
            "recall": np.where(tp + fn > 0, tp / (tp + fn), 0.0),
            "f1": np.where(2 * tp + fp + fn > 0, 2 * tp / (2 * tp + fp + fn), 0.0),
        }
    ratio_err = 0.0
    for name, per_class in macro.items():
        err = abs(float(res[name]) - float(per_class[present].mean()))
        ratio_err = max(ratio_err, err)
        check(err <= COLLECTION_RATIO_ATOL, f"macro {name} {float(res[name])} vs host: {err}")
    row_sums = cm_ref.sum(1, keepdims=True)
    cm_true_ref = np.where(row_sums > 0, cm_ref / np.maximum(row_sums, 1), 0.0)
    cm_true_err = float(np.abs(res["cm_true"].cpu().numpy() - cm_true_ref).max())
    check(cm_true_err <= COLLECTION_RATIO_ATOL, f"normalized confusion matrix vs host: {cm_true_err}")
    binned_err = abs(float(res["auroc_binned"]) - binned_ref)
    check(binned_err <= BINNED_AUROC_ATOL, f"binned AUROC vs numpy: {binned_err}")
    exact_err = abs(float(res["auroc_exact"]) - exact_ref)
    check(exact_err <= EXACT_AUROC_ATOL, f"exact AUROC vs rank sum: {exact_err}")

    # one binned update's temporaries: the (N, C, T) compares and their int64 sums
    p, t = logits[:batch], target[:batch]
    binned_only = tt.MulticlassAUROC(num_classes=c, thresholds=n_thresholds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    binned_only.update(p, t)
    torch.cuda.synchronize()
    binned_update_peak = torch.cuda.max_memory_allocated() - base
    state = torch.zeros((c, c), dtype=torch.int32, device=dev)
    out = {
        "phase": "classification_collection", "samples": n_val, "classes": c, "batch": batch,
        "batches": len(starts), "forward_batches": n_forward, "update_batches": n_update,
        "compute_groups": mc.compute_groups, "confmat_launches": launches,
        "results": {k: float(v) for k, v in res.items() if v.numel() == 1},
        "max_err": {"macro_ratios": ratio_err, "cm_true": cm_true_err, "auroc_binned": binned_err,
                    "auroc_exact": exact_err},
        "tolerance": {"counts": "exact", "micro_accuracy": "exact", "macro_ratios": COLLECTION_RATIO_ATOL,
                      "auroc_binned_vs_numpy": BINNED_AUROC_ATOL, "auroc_exact_vs_rank_sum": EXACT_AUROC_ATOL},
        "seconds": stream_s, "batches_per_s": len(starts) / stream_s, "samples_per_s": n_val / stream_s,
        "update_ms": statistics.median(call_ms["update"]), "forward_ms": statistics.median(call_ms["forward"]),
        "first_call_ms": call_ms["forward"][0], "compute_ms": compute_ms,
        "peak_mem_bytes": peak, "binned_auroc_update_peak_bytes": binned_update_peak,
        # what a copy of one member's 4 MB (1000, 1000) int32 state would cost, were group states copied
        "state_clone_ms_4mb": median_ms(torch, lambda: state.clone(), reps=50),
        "card": smi,
    }
    emit(out)
    return out


def phase_aggregation(torch, np, dev, gen) -> None:
    """Mean, Sum, Max, Cat and RunningMean(window=5) over 49 batches of 16 per-sample losses made on the card,
    one batch with NaNs, under ``nan_strategy="ignore"``; each within ``AGG_RTOL`` of float64 on the host."""
    import torchmetrics_tpu_torch as tt

    losses = torch.rand((49, 16), generator=gen, device=dev) * 3.0 + 0.05
    losses[7, ::5] = float("nan")
    metrics = {
        "mean": tt.MeanMetric(nan_strategy="ignore"), "sum": tt.SumMetric(nan_strategy="ignore"),
        "max": tt.MaxMetric(nan_strategy="ignore"), "cat": tt.CatMetric(nan_strategy="ignore"),
        "running_mean": tt.RunningMean(window=5, nan_strategy="ignore"),
    }
    for b in range(losses.shape[0]):
        for name, m in metrics.items():
            m(losses[b]) if b % 2 == 0 else m.update(losses[b])
    got = {name: m.compute() for name, m in metrics.items()}
    check(all(v.device == dev for v in got.values()), "an aggregate left the card")
    host = losses.cpu().numpy().astype(np.float64)
    kept = host[~np.isnan(host)]
    window = host[-5:][~np.isnan(host[-5:])]
    want = {"mean": kept.mean(), "sum": kept.sum(), "max": kept.max(), "running_mean": window.mean()}
    errs = {name: abs(float(got[name]) - w) / abs(w) for name, w in want.items()}
    cat = got["cat"].cpu().numpy().astype(np.float64)
    errs["cat"] = float(np.abs(cat - kept).max() / np.abs(kept).max()) if cat.shape == kept.shape else float("inf")
    for name, err in errs.items():
        check(err <= AGG_RTOL, f"{name}: relative error {err} > {AGG_RTOL}")
    emit({"phase": "aggregation", "batches": losses.shape[0], "values": int(kept.size), "nan_values": int(np.isnan(host).sum()),
          "results": {k: float(v) for k, v in got.items() if v.numel() == 1}, "max_rel_err": errs, "rtol": AGG_RTOL})


# ---------------------------------------------------------------------------------------------------------------
# the rest of classification: MCC, kappa and Jaccard on B1, specificity, Hamming, exact match, average precision,
# the operating points, calibration, hinge, ranking, Dice and fairness; each against float64 numpy on the host


def _host_confmat_scores(cm) -> dict:
    """float64 MCC, Cohen's kappa (no weights), per-class IoU and macro IoU (absent classes dropped) of a
    confusion matrix, and the per-class macro specificity and Hamming distance of its stat scores."""
    import numpy as np

    cm = cm.astype(np.float64)
    tp, rows, cols = np.diag(cm), cm.sum(1), cm.sum(0)
    s, c = cm.sum(), tp.sum()
    den = (s * s - cols @ cols) * (s * s - rows @ rows)
    kappa_w = 1.0 - np.eye(cm.shape[0])
    union = rows + cols - tp
    fp, fn = cols - tp, rows - tp
    tn = s - tp - fp - fn
    present = tp + fp + fn > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, tp / union, 0.0)
        specificity = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        hamming = 1.0 - np.where(tp + fn > 0, tp / (tp + fn), 0.0)
    return {
        "mcc": (c * s - rows @ cols) / np.sqrt(den) if den > 0 else 0.0,
        "kappa": 1.0 - (kappa_w * cm).sum() / (kappa_w * np.outer(rows, cols) / s).sum(),
        "iou": iou, "miou": iou[union > 0].mean(),
        "specificity": specificity[present].mean(), "hamming": hamming[present].mean(),
    }


def _host_operating_point(value, other, mask, thresholds):
    """Max ``value`` where ``mask``, ties to the max ``other``, the first such threshold; 0 and 1e6 where none."""
    import numpy as np

    if not mask.any():
        return 0.0, 1e6
    best = value[mask].max()
    tie = mask & (value == best)
    idx = int(np.argmax(tie & (other == other[tie].max())))
    return float(best), (1e6 if best == 0 else float(thresholds[idx]))


def _host_class_curves(scores, positives, thresholds, op: str) -> dict:
    """Per column of ``scores`` (the card's float32 probabilities) against ``positives``, in float64.

    ``ap_exact``: a stable descending sort and cumulative sums, each distinct score one point, as the
    reference's exact curve. On the binned ``thresholds`` (a score counts at a threshold it reaches):
    ``ap_binned``; ``op`` at 0.5, recall at fixed precision (``"rfp"``) or precision at fixed recall
    (``"pfr"``), with its threshold; and specificity at sensitivity 0.5 with its threshold, read from the ROC
    in descending thresholds.
    """
    import numpy as np

    n, k = scores.shape
    out = {name: np.empty(k) for name in ("ap_exact", "ap_binned", "op", "op_thr", "sas", "sas_thr")}
    for j in range(k):
        s, y = scores[:, j], positives[:, j]
        order = np.argsort(-s, kind="stable")
        idx = np.r_[np.nonzero(np.diff(s[order]))[0], n - 1]
        tps = np.cumsum(y[order])[idx].astype(np.float64)
        fps = 1 + idx - tps
        prec = np.r_[(tps / (tps + fps))[::-1], 1.0]
        rec = np.r_[(tps / tps[-1])[::-1], 0.0]
        out["ap_exact"][j] = -np.sum((rec[1:] - rec[:-1]) * prec[:-1])
        n_pos = int(y.sum())
        tp = (n_pos - np.searchsorted(np.sort(s[y]), thresholds, side="left")).astype(np.float64)
        fp = n - np.searchsorted(np.sort(s), thresholds, side="left") - tp
        fn, tn = n_pos - tp, (n - n_pos) - fp
        p = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        r = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        big_p, big_r = np.r_[p, 1.0], np.r_[r, 0.0]
        out["ap_binned"][j] = -np.sum((big_r[1:] - big_r[:-1]) * big_p[:-1])
        if op == "rfp":
            out["op"][j], out["op_thr"][j] = _host_operating_point(r, p, p >= 0.5, thresholds)
        else:
            out["op"][j], out["op_thr"][j] = _host_operating_point(p, r, r >= 0.5, thresholds)
        spec = 1.0 - np.where(fp + tn > 0, fp / np.maximum(fp + tn, 1), 0.0)[::-1]
        sens = r[::-1]
        mask = sens >= 0.5
        if mask.any():
            out["sas"][j] = spec[mask].max()
            out["sas_thr"][j] = thresholds[::-1][int(np.argmax(mask & (spec == out["sas"][j])))]
        else:
            out["sas"][j], out["sas_thr"][j] = 0.0, 1e6
    return out


def _host_ranking(probs, target) -> dict:
    """Label-ranking AP, ranking loss and coverage error in float64, tied scores at their average rank."""
    import numpy as np

    n, labels = probs.shape
    sums = {"ranking_ap": 0.0, "ranking_loss": 0.0, "coverage": 0.0}
    for lo in range(0, n, 2048):
        s, rel = probs[lo:lo + 2048].astype(np.float64), target[lo:lo + 2048] == 1
        gt = s[:, None, :] > s[:, :, None]  # [b, j, m]: label m scored above label j
        eq = s[:, None, :] == s[:, :, None]
        rank_all = gt.sum(-1) + (eq.sum(-1) + 1) / 2
        rank_rel = (gt & rel[:, None, :]).sum(-1) + ((eq & rel[:, None, :]).sum(-1) + 1) / 2
        n_rel = rel.sum(1)
        ratio = np.where(rel, rank_rel / rank_all, 0.0).sum(1)
        sums["ranking_ap"] += np.where((n_rel > 0) & (n_rel < labels), ratio / np.maximum(n_rel, 1), 1.0).sum()
        miss = ((gt | eq) & rel[:, :, None] & ~rel[:, None, :]).sum((1, 2))
        denom = n_rel * (labels - n_rel)
        sums["ranking_loss"] += np.where(denom > 0, miss / np.maximum(denom, 1), 0.0).sum()
        min_rel = np.where(rel, s, np.inf).min(1)
        sums["coverage"] += np.where(n_rel > 0, (s >= min_rel[:, None]).sum(1), 0).sum()
    return {k: v / n for k, v in sums.items()}


def _host_calibration(probs, target, boundaries) -> dict:
    """Top-1 ECE (l1) and MCE (max) in float64 over the float32 ``boundaries``, right-closed as searchsorted(right)."""
    import numpy as np

    conf, hit = probs.max(1), (probs.argmax(1) == target).astype(np.float64)
    n_bins = len(boundaries) - 1
    idx = np.clip(np.searchsorted(boundaries[1:-1], conf, side="right"), 0, n_bins - 1)
    counts = np.bincount(idx, minlength=n_bins).astype(np.float64)
    safe = np.maximum(counts, 1)
    gap = np.abs(np.bincount(idx, weights=hit, minlength=n_bins) / safe
                 - np.bincount(idx, weights=conf.astype(np.float64), minlength=n_bins) / safe)
    return {"l1": float((gap * counts / len(conf)).sum()), "max": float(gap.max())}


def _launches_per_update(torch, kernel, mc, batches) -> list:
    """Stream ``batches`` through ``mc.update``; B1's launches in each update (its count is reset first)."""
    per_update = []
    kernel.confusion_matrix_cuda.launches.reset()
    for args in batches:
        before = int(kernel.confusion_matrix_cuda.launches)
        mc.update(*args)
        per_update.append(int(kernel.confusion_matrix_cuda.launches) - before)
    torch.cuda.synchronize()
    return per_update


def _groups(mc) -> set:
    return {frozenset(g) for g in mc.compute_groups.values()}


def _compute_ms(torch, mc, names) -> dict:
    """Each member's own ``compute``, on the host clock after a device synchronize."""
    out = {}
    for name in names:
        t0 = time.perf_counter()
        mc[name].compute()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
    return out


def phase_ade20k_miou(torch, np, kernel, dev, seg_preds, seg_target, ade_cm, smi: str) -> int:
    """Mean IoU on ADE20K-Full: the ade20k_full maps (847 classes, 8 updates of 16 maps of 512x512, 10% void under
    ``ignore_index=-1``) through one ``MetricCollection`` of the confusion matrix, macro and per-class Jaccard, MCC and
    kappa. One compute group; B1 once an update once the group is known (the first update runs every member, to
    find the groups). Values against float64 numpy from the exact matrix, and equal to each metric run alone.
    Returns B1's launches.
    """
    import torchmetrics_tpu_torch as tt

    c = 847

    def members():
        return {
            "cm": tt.MulticlassConfusionMatrix(num_classes=c, ignore_index=-1),
            "miou": tt.MulticlassJaccardIndex(num_classes=c, average="macro", ignore_index=-1),
            "iou": tt.MulticlassJaccardIndex(num_classes=c, average="none", ignore_index=-1),
            "mcc": tt.MulticlassMatthewsCorrCoef(num_classes=c, ignore_index=-1),
            "kappa": tt.MulticlassCohenKappa(num_classes=c, ignore_index=-1),
        }

    mc = tt.MetricCollection(members())
    updates = [(seg_preds[u], seg_target[u]) for u in range(seg_preds.shape[0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_update = _launches_per_update(torch, kernel, mc, updates)
    stream_s = time.perf_counter() - t0
    res = mc.compute()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = sum(per_update)
    check(_groups(mc) == {frozenset(members())}, f"compute groups {mc.compute_groups}")
    check(per_update == [len(members())] + [1] * (len(updates) - 1),
          f"B1 launches per update {per_update}: every member once on the first update, then the group head once")
    check(torch.equal(res["cm"], ade_cm), "the collection's confusion matrix != the ade20k_full one")

    host = _host_confmat_scores(ade_cm.cpu().numpy())
    errs = {
        "miou": abs(float(res["miou"]) - host["miou"]),
        "iou": float(np.abs(res["iou"].cpu().numpy().astype(np.float64) - host["iou"]).max()),
        "mcc": abs(float(res["mcc"]) - host["mcc"]) / abs(host["mcc"]),
        "kappa": abs(float(res["kappa"]) - host["kappa"]) / abs(host["kappa"]),
    }
    check(errs["miou"] <= SLICE6_ATOL and errs["iou"] <= SLICE6_ATOL, f"IoU vs float64: {errs}")
    check(errs["mcc"] <= MCC_KAPPA_RTOL and errs["kappa"] <= MCC_KAPPA_RTOL, f"MCC/kappa vs float64: {errs}")
    alone = members()
    for args in updates:
        for m in alone.values():
            m.update(*args)
    for name, m in alone.items():
        check(torch.equal(m.compute(), res[name]), f"{name}: collection result != the metric outside a collection")
    emit({
        "phase": "ade20k_miou", "classes": c, "updates": len(updates), "pixels": int(ade_cm.sum()),
        "compute_groups": mc.compute_groups, "confmat_launches": launches, "launches_per_update": per_update,
        "miou": float(res["miou"]), "mcc": float(res["mcc"]), "kappa": float(res["kappa"]),
        "host_float64": {"miou": host["miou"], "mcc": host["mcc"], "kappa": host["kappa"]},
        "err": errs, "tolerance": {"iou_abs": SLICE6_ATOL, "mcc_kappa_rel": MCC_KAPPA_RTOL},
        "seconds": stream_s, "updates_per_s": len(updates) / stream_s, "peak_mem_bytes": peak, "card": smi,
    })
    return launches


def phase_classification_rest(torch, np, kernel, dev, logits, target, smi: str, batch: int = 1024) -> int:
    """The rest of classification on the imagenet_val data (50,000 x 1000, batches of 1024) in one
    ``MetricCollection``: MCC, kappa and Jaccard (one confusion-matrix group, B1), specificity and Hamming (one
    stat-scores group), average precision binned at 100 thresholds and exact, recall at precision 0.5 and
    specificity at sensitivity 0.5 (binned, one group with the binned AP), ECE and MCE (15 bins) and the
    Crammer-Singer hinge loss. Each against float64 numpy on the host, the curves computed in worker processes
    while the card streams. Returns B1's launches.
    """
    import torchmetrics_tpu_torch as tt
    from torchmetrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries

    n, c = logits.shape
    mc = tt.MetricCollection({
        "mcc": tt.MulticlassMatthewsCorrCoef(num_classes=c),
        "kappa": tt.MulticlassCohenKappa(num_classes=c),
        "jaccard": tt.MulticlassJaccardIndex(num_classes=c),
        "specificity": tt.MulticlassSpecificity(num_classes=c),
        "hamming": tt.MulticlassHammingDistance(num_classes=c),
        "ap_binned": tt.MulticlassAveragePrecision(num_classes=c, thresholds=100),
        "ap_exact": tt.MulticlassAveragePrecision(num_classes=c),
        "recall_at_precision": tt.MulticlassRecallAtFixedPrecision(num_classes=c, min_precision=0.5, thresholds=100),
        "specificity_at_sensitivity": tt.MulticlassSpecificityAtSensitivity(num_classes=c, min_sensitivity=0.5,
                                                                              thresholds=100),
        "ece": tt.MulticlassCalibrationError(num_classes=c, n_bins=15, norm="l1"),
        "mce": tt.MulticlassCalibrationError(num_classes=c, n_bins=15, norm="max"),
        "hinge": tt.MulticlassHingeLoss(num_classes=c),
    })
    starts = list(range(0, n, batch))
    probs = torch.cat([torch.softmax(logits[s:s + batch], dim=1) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["ap_binned"].thresholds.cpu().numpy()
    step = -(-c // 4)
    chunks = [(lo, min(lo + step, c)) for lo in range(0, c, step)]
    with ProcessPoolExecutor(max_workers=len(chunks), mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(_host_class_curves, probs[:, lo:hi], host_t[:, None] == np.arange(lo, hi)[None],
                             thresholds, "rfp") for lo, hi in chunks]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        per_update = _launches_per_update(torch, kernel, mc, [(logits[s:s + batch], target[s:s + batch])
                                                              for s in starts])
        stream_s = time.perf_counter() - t0
        compute_ms = _compute_ms(torch, mc, list(mc.keys()))
        res = mc.compute()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        curves = {key: np.concatenate([p.result()[key] for p in parts]) for key in parts[0].result()}
    launches = sum(per_update)
    want_groups = {frozenset({"mcc", "kappa", "jaccard"}), frozenset({"specificity", "hamming"}),
                   frozenset({"ap_binned", "recall_at_precision", "specificity_at_sensitivity"}),
                   frozenset({"ap_exact"}), frozenset({"ece", "mce"}), frozenset({"hinge"})}
    check(_groups(mc) == want_groups, f"compute groups {mc.compute_groups}")
    check(per_update == [3] + [1] * (len(starts) - 1),
          f"B1 launches per update {per_update}: 3 members on the first update, then the group head once")

    cm = np.bincount(host_t * c + logits.argmax(1).cpu().numpy(), minlength=c * c).reshape(c, c)
    check(np.array_equal(mc._modules["mcc"].confmat.cpu().numpy(), cm), "confusion matrix != host bincount")
    scores = _host_confmat_scores(cm)
    calib = _host_calibration(probs, host_t, _bin_boundaries(15).numpy())
    p_true = probs[np.arange(n), host_t].astype(np.float64)
    others = probs.copy()
    others[np.arange(n), host_t] = -np.inf
    hinge = np.clip(1.0 - (p_true - others.max(1)), 0.0, None).mean()
    errs = {name: abs(float(res[name]) - scores[key]) for name, key in
            (("mcc", "mcc"), ("kappa", "kappa"), ("jaccard", "miou"), ("specificity", "specificity"),
             ("hamming", "hamming"))}
    errs["ap_binned"] = abs(float(res["ap_binned"]) - curves["ap_binned"].mean())
    errs["ap_exact"] = abs(float(res["ap_exact"]) - np.nanmean(curves["ap_exact"]))
    rap, rap_thr = (x.cpu().numpy() for x in res["recall_at_precision"])
    sas, sas_thr = (x.cpu().numpy() for x in res["specificity_at_sensitivity"])
    errs["recall_at_precision"] = float(np.abs(rap - curves["op"]).max())
    errs["specificity_at_sensitivity"] = float(np.abs(sas - curves["sas"]).max())
    errs["ece"] = abs(float(res["ece"]) - calib["l1"])
    errs["mce"] = abs(float(res["mce"]) - calib["max"])
    errs["hinge"] = abs(float(res["hinge"]) - hinge) / hinge
    tolerance = {name: SLICE6_ATOL for name in errs}
    tolerance.update({"ap_exact": EXACT_AP_ATOL, "ece": CALIBRATION_ATOL, "mce": CALIBRATION_ATOL,
                      "hinge": SUM_RTOL})
    for name, err in errs.items():
        check(err <= tolerance[name], f"{name} vs float64 numpy: {err} > {tolerance[name]}")
    check(np.array_equal(rap_thr, curves["op_thr"].astype(np.float32)), "recall@precision thresholds != host")
    check(np.array_equal(sas_thr, curves["sas_thr"].astype(np.float32)), "specificity@sensitivity thresholds != host")
    emit({
        "phase": "classification_rest", "samples": n, "classes": c, "batch": batch, "batches": len(starts),
        "compute_groups": mc.compute_groups, "confmat_launches": launches, "launches_per_update": per_update[:3],
        "results": {k: float(v) for k, v in res.items() if isinstance(v, torch.Tensor) and v.numel() == 1},
        "err": errs, "tolerance": tolerance, "thresholds": "exact",
        "seconds": stream_s, "batches_per_s": len(starts) / stream_s, "samples_per_s": n / stream_s,
        "compute_ms": compute_ms, "peak_mem_bytes": peak, "card": smi,
    })
    return launches


def phase_coco_multilabel(torch, np, dev, gen, smi: str, n_img: int = 40_504, labels: int = 80,
                          batch: int = 256) -> None:
    """MS-COCO 2014's multilabel evaluation shape (val2014: 40,504 images, 80 labels, ~2.9 positive an image; logits
    made from the seed, positives shifted up) in batches of 256, through one ``MetricCollection``: average precision
    exact and binned, precision at recall 0.5, the three ranking metrics, exact match, Hamming, Jaccard, MCC and
    specificity. Against float64 numpy on the host, computed in worker processes while the card streams."""
    import torchmetrics_tpu_torch as tt

    target = (torch.rand((n_img, labels), generator=gen, device=dev) < 2.9 / labels).to(torch.int64)
    logits = torch.randn((n_img, labels), generator=gen, device=dev) + 4.0 * target - 2.0
    mc = tt.MetricCollection({
        "ap_exact": tt.MultilabelAveragePrecision(num_labels=labels),
        "ap_binned": tt.MultilabelAveragePrecision(num_labels=labels, thresholds=100),
        "precision_at_recall": tt.MultilabelPrecisionAtFixedRecall(num_labels=labels, min_recall=0.5, thresholds=100),
        "ranking_ap": tt.MultilabelRankingAveragePrecision(num_labels=labels),
        "ranking_loss": tt.MultilabelRankingLoss(num_labels=labels),
        "coverage": tt.MultilabelCoverageError(num_labels=labels),
        "exact_match": tt.MultilabelExactMatch(num_labels=labels),
        "hamming": tt.MultilabelHammingDistance(num_labels=labels),
        "jaccard": tt.MultilabelJaccardIndex(num_labels=labels),
        "mcc": tt.MultilabelMatthewsCorrCoef(num_labels=labels),
        "specificity": tt.MultilabelSpecificity(num_labels=labels),
    })
    starts = list(range(0, n_img, batch))
    probs = torch.cat([torch.sigmoid(logits[s:s + batch]) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["ap_binned"].thresholds.cpu().numpy()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(_host_class_curves, probs[:, lo:lo + 20], host_t[:, lo:lo + 20] == 1, thresholds, "pfr")
                 for lo in range(0, labels, 20)]
        ranking = pool.submit(_host_ranking, probs, host_t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for s in starts:
            mc.update(logits[s:s + batch], target[s:s + batch])
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        compute_ms = _compute_ms(torch, mc, list(mc.keys()))
        res = mc.compute()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        curves = {key: np.concatenate([p.result()[key] for p in parts]) for key in parts[0].result()}
        rank = ranking.result()
    want_groups = {frozenset({"ap_binned", "precision_at_recall"}), frozenset({"hamming", "specificity"}),
                   frozenset({"jaccard", "mcc"}), frozenset({"ap_exact"}), frozenset({"ranking_ap"}),
                   frozenset({"ranking_loss"}), frozenset({"coverage"}), frozenset({"exact_match"})}
    check(_groups(mc) == want_groups, f"compute groups {mc.compute_groups}")

    pred = probs > 0.5
    pos = host_t == 1
    tp, fp = (pred & pos).sum(0).astype(np.float64), (pred & ~pos).sum(0).astype(np.float64)
    fn, tn = (~pred & pos).sum(0).astype(np.float64), (~pred & ~pos).sum(0).astype(np.float64)
    states = mc._modules["hamming"]
    for name, want in (("tp", tp), ("fp", fp), ("tn", tn), ("fn", fn)):
        check(np.array_equal(getattr(states, name).cpu().numpy(), want), f"multilabel stat scores {name} != host")
    t_all, p_all, n_all, f_all = tp.sum(), fp.sum(), tn.sum(), fn.sum()
    mcc = (t_all * n_all - p_all * f_all) / np.sqrt((t_all + p_all) * (t_all + f_all) * (n_all + p_all) * (n_all + f_all))
    want = {
        "ap_exact": np.nanmean(curves["ap_exact"]), "ap_binned": curves["ap_binned"].mean(),
        "exact_match": (pred == pos).all(1).mean(), "hamming": (1.0 - (tp + tn) / (tp + tn + fp + fn)).mean(),
        "jaccard": (tp / (tp + fp + fn)).mean(), "mcc": mcc, "specificity": (tn / (tn + fp)).mean(), **rank,
    }
    errs = {name: abs(float(res[name]) - w) for name, w in want.items()}
    for name in ("ranking_ap", "ranking_loss", "coverage"):
        errs[name] /= abs(want[name])
    par, par_thr = (x.cpu().numpy() for x in res["precision_at_recall"])
    errs["precision_at_recall"] = float(np.abs(par - curves["op"]).max())
    tolerance = {name: SLICE6_ATOL for name in errs}
    tolerance.update({"ap_exact": EXACT_AP_ATOL, "ranking_ap": SUM_RTOL, "ranking_loss": SUM_RTOL,
                      "coverage": SUM_RTOL})
    for name, err in errs.items():
        check(err <= tolerance[name], f"coco {name} vs float64 numpy: {err} > {tolerance[name]}")
    check(np.array_equal(par_thr, curves["op_thr"].astype(np.float32)), "precision@recall thresholds != host")
    emit({
        "phase": "coco_multilabel", "images": n_img, "labels": labels, "batch": batch, "batches": len(starts),
        "positives_per_image": float(pos.sum() / n_img), "compute_groups": mc.compute_groups,
        "results": {k: float(v) for k, v in res.items() if isinstance(v, torch.Tensor) and v.numel() == 1},
        "err": errs, "tolerance": tolerance, "seconds": stream_s, "images_per_s": n_img / stream_s,
        "compute_ms": compute_ms, "peak_mem_bytes": peak, "card": smi,
    })


def phase_dice_fairness(torch, np, dev, gen, smi: str, maps: int = 8, side: int = 512, n: int = 19_962) -> None:
    """Dice (150 classes, macro, mdmc global) on SceneParse150-shaped maps, 4 updates of 8 maps of 512x512: its
    stat scores exactly against numpy counts, the score within ``SLICE6_ATOL``, and the peak memory of one update's
    one-hot temporaries. ``BinaryFairness`` and ``BinaryGroupStatRates`` on CelebA's test split shape (19,962
    samples) with 2 and 4 groups: per-group counts exact, rates and ratios within ``SLICE6_ATOL``."""
    import torchmetrics_tpu_torch as tt

    c, n_updates = 150, 4
    shape = (n_updates, maps, side, side)
    target = torch.randint(0, c, shape, generator=gen, device=dev)
    preds = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.6, target,
                        torch.randint(0, c, shape, generator=gen, device=dev))
    dice = tt.Dice(num_classes=c, average="macro", mdmc_average="global")
    update_peaks = []
    t0 = time.perf_counter()
    for u in range(n_updates):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dice.update(preds[u], target[u])
        torch.cuda.synchronize()
        update_peaks.append(torch.cuda.max_memory_allocated() - base)
    value = float(dice.compute())
    dice_s = time.perf_counter() - t0
    hp, ht = preds.cpu().numpy().reshape(-1), target.cpu().numpy().reshape(-1)
    tp = np.bincount(ht[hp == ht], minlength=c)
    fp, fn = np.bincount(hp, minlength=c) - tp, np.bincount(ht, minlength=c) - tp
    for name, want in (("tp", tp), ("fp", fp), ("fn", fn)):
        check(np.array_equal(getattr(dice, name).cpu().numpy(), want), f"Dice {name} != numpy counts")
    present = tp + fp + fn > 0
    dice_ref = (2 * tp / np.maximum(2 * tp + fp + fn, 1))[present].mean()
    dice_err = abs(value - dice_ref)
    check(dice_err <= SLICE6_ATOL, f"Dice vs float64: {dice_err}")

    fairness = {}  # n: CelebA's test split
    for groups in (2, 4):
        scores = torch.rand(n, generator=gen, device=dev)
        labels = (torch.rand(n, generator=gen, device=dev) < 0.45).to(torch.int64)
        group_ids = torch.randint(0, groups, (n,), generator=gen, device=dev)
        fair, rates = tt.BinaryFairness(num_groups=groups), tt.BinaryGroupStatRates(num_groups=groups)
        for lo in range(0, n, 4096):
            args = (scores[lo:lo + 4096], labels[lo:lo + 4096], group_ids[lo:lo + 4096])
            fair.update(*args)
            rates.update(*args)
        got_fair, got_rates = fair.compute(), rates.compute()
        hs, hl, hg = scores.cpu().numpy() > 0.5, labels.cpu().numpy() == 1, group_ids.cpu().numpy()
        counts = {name: np.array([(m & (hg == g)).sum() for g in range(groups)]) for name, m in
                  (("tp", hs & hl), ("fp", hs & ~hl), ("tn", ~hs & ~hl), ("fn", ~hs & hl))}
        for name, want in counts.items():
            check(np.array_equal(getattr(fair, name).cpu().numpy(), want), f"fairness {name} != numpy ({groups} groups)")
        pos_rate = (counts["tp"] + counts["fp"]) / (counts["tp"] + counts["fp"] + counts["tn"] + counts["fn"])
        tpr = counts["tp"] / (counts["tp"] + counts["fn"])
        want = {f"DP_{pos_rate.argmin()}_{pos_rate.argmax()}": pos_rate.min() / pos_rate.max(),
                f"EO_{tpr.argmin()}_{tpr.argmax()}": tpr.min() / tpr.max()}
        check(sorted(got_fair) == sorted(want), f"fairness keys {sorted(got_fair)} != {sorted(want)}")
        err = max(abs(float(got_fair[k]) - w) for k, w in want.items())
        stats = np.stack([counts[k] for k in ("tp", "fp", "tn", "fn")], 1)
        rate_ref = stats / stats.sum(1, keepdims=True)
        err = max(err, max(float(np.abs(got_rates[f"group_{g}"].cpu().numpy() - rate_ref[g]).max())
                           for g in range(groups)))
        check(err <= SLICE6_ATOL, f"fairness vs float64 ({groups} groups): {err}")
        fairness[groups] = {"results": {k: float(v) for k, v in got_fair.items()}, "max_err": err}
    emit({
        "phase": "dice_fairness", "dice": {"classes": c, "updates": n_updates, "pixels": int(hp.size), "value": value,
                                           "err": dice_err, "seconds": dice_s,
                                           "onehot_update_peak_bytes": max(update_peaks)},
        "fairness": {"samples": n, "by_groups": fairness}, "tolerance": {"counts": "exact", "values": SLICE6_ATOL},
        "card": smi,
    })


def lpips_tap_shapes(torch, dev, net_type: str, pairs: int, side: int) -> list:
    """``(B, H, W, C)`` of each LPIPS tap's half for ``pairs`` image pairs of ``side`` x ``side``."""
    from torchmetrics_tpu_torch.image._inception import init_weights_
    from torchmetrics_tpu_torch.image._lpips import LPIPSNet
    from torchmetrics_tpu_torch.utilities.convert import build_on_cpu

    trunk = init_weights_(build_on_cpu(LPIPSNet, net_type=net_type, dtype=torch.bfloat16), 0).net
    trunk = trunk.to(device=dev, memory_format=torch.channels_last)
    x = torch.zeros((2 * pairs, 3, side, side), device=dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return [(pairs, f.shape[2], f.shape[3], f.shape[1]) for f in trunk(x)]


def phase_lpips_head_vs_plain(torch, lh, tap_shapes: dict, dev, gen) -> dict:
    """B3 at every tap shape, on float32 and on bf16 maps (the trunk's dtype), against its plain version;
    two calls on the same inputs must give the same bits (one cluster a row, fixed-order sums).

    ``"odd"`` shapes (C not a multiple of a 16-byte vector) and ``"misaligned"``
    ones (maps one element past a 16-byte boundary) take the kernel's
    element-wise loads.
    """
    cases, worst_rel, worst_abs = 0, 0.0, 0.0
    for net_type, shapes in tap_shapes.items():
        for shape in shapes:
            f0 = torch.randn(shape, generator=gen, device=dev).relu_()
            f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
            w = torch.rand(shape[-1], generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                a, b = f0.to(dtype), f1.to(dtype)
                if net_type == "misaligned":
                    a, b = (torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(shape).copy_(x) for x in (a, b))
                got = lh.lpips_head(a, b, w)
                again = lh.lpips_head(a, b, w)
                ref = lh.lpips_head_plain(a, b, w)
                torch.cuda.synchronize()
                err = (got - ref).abs()
                rel = float((err / ref.abs()).max())
                name = f"B3 {net_type} {shape} {str(dtype).split('.')[-1]}"
                check(bool((err <= HEAD_RTOL * ref.abs() + 1e-7).all()), f"{name}: max rel err {rel}")
                check(torch.equal(got, again), f"{name}: two calls differ in their bits")
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, float(err.max()))
                cases += 1
                del a, b
            del f0, f1
    emit({
        "phase": "lpips_head_vs_plain", "cases": cases, "dtypes": ["float32", "bfloat16"], "max_rel_err": worst_rel,
        "max_abs_err": worst_abs, "bit_identical_repeats": cases,
        "tolerance": f"|err| <= {HEAD_RTOL} * |ref| + 1e-7 (the JAX package's rtol); repeats: identical bits",
    })
    return {"max_rel_err": worst_rel, "max_abs_err": worst_abs}


def host_fid(np, states: dict) -> dict:
    """FID in float64 on the host from a FID metric's six states (numpy ``eigh``, the metric's formula)."""
    def gaussian(prefix):
        n = float(states[f"{prefix}_features_num_samples"])
        mu = states[f"{prefix}_features_sum"] / n
        cov = (states[f"{prefix}_features_cov_sum"] - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov

    mu1, s1 = gaussian("real")
    mu2, s2 = gaussian("fake")
    w1, v1 = np.linalg.eigh(s1)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt_s1 @ s2 @ sqrt_s1
    tr_covmean = np.sqrt(np.clip(np.linalg.eigvalsh((inner + inner.T) / 2), 0.0, None)).sum()
    diff = mu1 - mu2
    return {
        "fid": float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean),
        "trace_sum": float(np.trace(s1) + np.trace(s2)),
        "min_eig_real": float(w1.min()), "max_eig_real": float(w1.max()),
    }


def phase_fid(torch, np, ce, dev, gen, npz: str, n_img: int = 10_000, batch: int = 200) -> dict:
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor
    from torchmetrics_tpu_torch.utilities.compute import full_fp32

    real = torch.randint(0, 256, (n_img, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    noise = torch.randint(-20, 21, real.shape, generator=gen, device=dev, dtype=torch.int16)
    fake = (real.to(torch.int16) + 24 + noise).clamp_(0, 255).to(torch.uint8)  # brighter, noisier copies
    fid = FrechetInceptionDistance(feature=2048, weights_path=npz)
    fid.inception(real[:batch])  # first call: lazy CUDA module loading and cuDNN heuristics, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.matmul_bias_relu.launches.reset()
    ce.bias_relu_.launches.reset()
    ce.conv_bias_act.layout_copies = 0
    t0 = time.perf_counter()
    for start in range(0, n_img, batch):
        fid.update(real[start:start + batch], real=True)
        fid.update(fake[start:start + batch], real=False)
    torch.cuda.synchronize()
    t_updates = time.perf_counter() - t0
    value = fid.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "conv_mm_bias_relu": int(ce.matmul_bias_relu.launches),
        "bias_relu": int(ce.bias_relu_.launches),
        "layout_copies": ce.conv_bias_act.layout_copies,
    }
    peak = torch.cuda.max_memory_allocated()
    forwards = 2 * n_img // batch
    check(launches["conv_mm_bias_relu"] == 40 * forwards, f"B2a launches {launches} for {forwards} forwards")
    check(launches["bias_relu"] == 54 * forwards, f"B2b launches {launches} for {forwards} forwards")
    check(launches["layout_copies"] == 0, f"channels_last copies {launches['layout_copies']}")

    states = {k: v.double().cpu().numpy() for k, v in fid.state_dict(all_states=True).items()}
    check(states["real_features_num_samples"] == n_img and states["fake_features_num_samples"] == n_img, "sample counts")
    ref = host_fid(np, states)
    fid_err = abs(float(value) - ref["fid"])
    check(bool(torch.isfinite(value)) and fid_err <= FID_RTOL * abs(ref["fid"]),
          f"FID {float(value)} vs float64 host {ref['fid']}")

    # the trunk: fused bf16 (the main path) and fused float32 against the literal float32 conv+BN graph
    imgs = real[:batch]
    unfused32 = InceptionFeatureExtractor(weights_path=npz, compute_dtype=torch.float32, fuse_bn=False)(imgs)
    fused32 = InceptionFeatureExtractor(weights_path=npz, compute_dtype=torch.float32)(imgs)
    fused16 = fid.inception(imgs)
    check(fused16.shape == (batch, 2048) and bool(torch.isfinite(fused16).all()), "fused bf16 features not finite")
    rel32, rel16 = rel_norm(torch, fused32, unfused32), rel_norm(torch, fused16, unfused32)
    check(rel32 <= TRUNK_F32_RTOL, f"fused float32 trunk vs unfused: {rel32}")
    check(rel16 <= TRUNK_BF16_RTOL, f"fused bf16 trunk vs unfused float32: {rel16}")

    # one update's split: the trunk, then the statistics it folds in
    feats = fid.inception(imgs)

    def statistics_part():
        f = feats.float()
        with full_fp32():
            cov = f.T @ f
        fid.real_features_sum.add_(f.sum(dim=0))
        fid.real_features_cov_sum.add_(cov)

    trunk_ms = median_ms(torch, lambda: fid.inception(imgs), reps=10)
    stats_ms = median_ms(torch, statistics_part, reps=10)
    update_ms = wall_ms(torch, lambda: fid.update(imgs, real=True), reps=10)
    profile = device_time_by_kernel(torch, lambda: fid.update(imgs, real=True))
    result = {
        "phase": "fid_cifar10_10k", "images": 2 * n_img, "batch": batch, "forwards": forwards,
        "fid": float(value), "fid_float64_host": ref["fid"], "fid_rel_err": fid_err / abs(ref["fid"]),
        "trace_sum": ref["trace_sum"], "real_cov_eig_range": [ref["min_eig_real"], ref["max_eig_real"]],
        "launches": launches, "launches_per_forward": {"conv_mm_bias_relu": 40, "bias_relu": 54},
        "trunk_rel_err": {"fused_f32_vs_unfused_f32": rel32, "fused_bf16_vs_unfused_f32": rel16},
        "seconds": seconds, "images_per_s": 2 * n_img / seconds, "updates_seconds": t_updates,
        "compute_seconds": seconds - t_updates, "peak_mem_bytes": peak,
        "update_split_ms": {"trunk": trunk_ms, "statistics": stats_ms, "update_wall": update_ms},
        "update_profile": profile,
    }
    emit(result)
    return result


def phase_lpips(torch, lh, dev, gen, n_pairs: int = 1000, batch: int = 50, side: int = 256) -> dict:
    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor

    img0 = torch.rand((n_pairs, 3, side, side), generator=gen, device=dev) * 2 - 1
    img1 = (img0 + 0.2 * torch.randn(img0.shape, generator=gen, device=dev)).clamp_(-1, 1)
    metric = LearnedPerceptualImagePatchSimilarity()  # alex, bf16 trunk, seeded random weights
    metric.net(img0[:batch], img1[:batch])  # first call, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lh.lpips_head.launches.reset()
    t0 = time.perf_counter()
    for start in range(0, n_pairs, batch):
        metric.update(img0[start:start + batch], img1[start:start + batch])
    score = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = int(lh.lpips_head.launches)
    peak = torch.cuda.max_memory_allocated()
    updates = n_pairs // batch
    check(launches == 5 * updates, f"B3 launches {launches} for {updates} alex forwards")

    oracle = LPIPSExtractor(net_type="alex", unfused=True)  # same seed, same weights
    oracle_sum = sum(float(oracle(img0[s:s + batch], img1[s:s + batch]).double().sum()) for s in range(0, n_pairs, batch))
    got_sum = float(metric.sum_scores)
    check(abs(got_sum - oracle_sum) <= HEAD_RTOL * abs(oracle_sum), f"alex sum {got_sum} vs unfused {oracle_sum}")
    profile = device_time_by_kernel(torch, lambda: metric.update(img0[:batch], img1[:batch]))
    # the head stage alone, on one update's bf16 taps: B3 reads them as they are, so no copy,
    # fill or division kernel runs beside its 5 launches (only the sum of the taps' distances)
    lpnet, taps = metric.net.net, []
    hook = lpnet.net.register_forward_hook(lambda mod, args, out: taps.extend(out))
    try:
        with torch.no_grad():
            # the net itself: the extractor's second call of this shape would run the hook at its warm-up and
            # again at its capture, and a replay runs none
            lpnet(img0[:batch], img1[:batch])
    finally:
        hook.remove()
    with torch.no_grad():
        heads = device_time_by_kernel(torch, lambda: lpnet.heads(taps, batch), top=20)
    names = [(row["kernel"], row["calls"]) for row in heads["top"]]
    b3_calls = sum(calls for name, calls in names if "lpips_head_kernel" in name)
    extra = [name for name, _ in names if any(word in name.lower() for word in ("copy", "fill", "div"))]
    check(heads["kernels"] == 0 or (b3_calls == 5 and not extra), f"head stage kernels {names}")
    result = {
        "phase": "lpips_pairs", "pairs": n_pairs, "batch": batch, "net_type": "alex", "lpips": float(score),
        "unfused_mean": oracle_sum / n_pairs, "rel_err": abs(got_sum - oracle_sum) / abs(oracle_sum),
        "launches": launches, "seconds": seconds, "pairs_per_s": n_pairs / seconds, "peak_mem_bytes": peak,
        "update_profile": profile,
        "head_stage": {"tap_dtypes": sorted({str(t.dtype).split(".")[-1] for t in taps}), "device_busy_ms": heads["device_busy_ms"],
                       "kernels": [[name[:40], calls] for name, calls in names], "copy_fill_div_kernels": len(extra)},
        "others": {},
    }
    for net_type, taps in (("vgg", 5), ("squeeze", 7)):
        other = LearnedPerceptualImagePatchSimilarity(net_type=net_type)
        lh.lpips_head.launches.reset()
        other.update(img0[:batch], img1[:batch])
        value = other.compute()
        torch.cuda.synchronize()
        count = int(lh.lpips_head.launches)
        check(count == taps, f"{net_type}: B3 launches {count}, expected {taps}")
        want = LPIPSExtractor(net_type=net_type, unfused=True)(img0[:batch], img1[:batch])
        got = other.net(img0[:batch], img1[:batch])
        err = float(((got - want).abs() / want.abs()).max())
        check(err <= HEAD_RTOL, f"{net_type}: per-pair rel err {err} vs unfused")
        result["others"][net_type] = {"lpips": float(value), "launches": count, "per_pair_max_rel_err": err}
    emit(result)
    return result


def phase_image_timing(torch, ce, lh, calls, lpips_taps, dev, gen, smi: str) -> dict:
    """CUDA-event medians at the main path's shapes; per-forward sums weight each shape by its count."""
    meta = lambda shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)  # noqa: E731
    rows = {"conv_mm_bias_relu": [], "bias_relu": [], "lpips_head": []}
    for call, count in collections.Counter(c for c in calls if is_pointwise(c)).items():
        m, k, n = gemm_shape(call)
        x = torch.randn((m, k), generator=gen, device=dev).relu_().bfloat16()
        w = (torch.randn((n, k), generator=gen, device=dev) / k**0.5).bfloat16()
        b = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
        bound, by = bound_ms(ce.conv_bias_act_cost(meta(call[0]), meta(call[1]), meta((n,))), BF16_FLOPS_PER_S)
        rows["conv_mm_bias_relu"].append({
            "shape": [m, k, n], "hw": f"{call[0][2]}x{call[0][3]}", "count": count, "bound_ms": bound, "bound_by": by,
            "ms": median_ms(torch, lambda: ce.matmul_bias_relu(x, w, b), reps=30),
            "plain_ms": median_ms(torch, lambda: ce.matmul_bias_relu_plain(x, w, b), reps=10),
            "library_ms": median_ms(torch, lambda: torch.addmm(b, x, w.T).relu_(), reps=30),
        })
    for shape, count in collections.Counter(rows_shape(c) for c in calls if not is_pointwise(c)).items():
        y = torch.randn(shape, generator=gen, device=dev).bfloat16()
        b = (0.1 * torch.randn(shape[1], generator=gen, device=dev)).bfloat16()
        bound, by = bound_ms(ce.bias_relu_cost(y, b), F32_FLOPS_PER_S)
        rows["bias_relu"].append({
            "shape": list(shape), "count": count, "bound_ms": bound, "bound_by": by,
            "ms": median_ms(torch, lambda: ce.bias_relu_(y, b), reps=30),
            "queued_ms": queued_ms(torch, lambda: ce.bias_relu_(y, b)),  # the launches alone, host cost queued ahead
            "plain_ms": median_ms(torch, lambda: ce.bias_relu_plain(y, b), reps=10),
            "library_ms": median_ms(torch, lambda: torch.add(y, b).relu_(), reps=30),
        })
    for shape in lpips_taps:  # the trunk's bf16 maps, as the main path hands them over; float32 beside
        f0 = torch.randn(shape, generator=gen, device=dev).relu_()
        f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
        w = torch.rand(shape[-1], generator=gen, device=dev)
        b0, b1 = f0.bfloat16(), f1.bfloat16()
        bound, by = bound_ms(lh.lpips_head_cost(b0, b1, w), F32_FLOPS_PER_S)
        rows["lpips_head"].append({
            "shape": list(shape), "count": 1, "bound_ms": bound, "bound_by": by,
            "ms": queued_ms(torch, lambda: lh.lpips_head(b0, b1, w)),
            "call_ms": median_ms(torch, lambda: lh.lpips_head(b0, b1, w), reps=30),
            "plain_ms": median_ms(torch, lambda: lh.lpips_head_plain(b0, b1, w), reps=10),
            "library_ms": None,
            "f32_ms": queued_ms(torch, lambda: lh.lpips_head(f0, f1, w)),
            "f32_call_ms": median_ms(torch, lambda: lh.lpips_head(f0, f1, w), reps=30),
            "f32_bound_ms": bound_ms(lh.lpips_head_cost(f0, f1, w), F32_FLOPS_PER_S)[0],
        })
    totals = {}
    for name, kernel_rows in rows.items():
        keys = [k for k in kernel_rows[0] if k.endswith("ms") and k != "library_ms"]
        total = {key: sum(r[key] * r["count"] for r in kernel_rows) for key in keys}
        lib = [r["library_ms"] for r in kernel_rows]
        total["library_ms"] = None if None in lib else sum(v * r["count"] for v, r in zip(lib, kernel_rows))
        total["launches_per_forward"] = sum(r["count"] for r in kernel_rows)
        by_bytes = sum(r["bound_ms"] * r["count"] for r in kernel_rows if r["bound_by"] == "bytes")
        total["bound_by"] = "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations"
        totals[name] = total
    groups = {}  # B2a by activation size: 73x73 (K 64), 35x35 (K 192-288), 17x17 (K 768), 8x8 (K 1280-2048)
    for r in rows["conv_mm_bias_relu"]:
        group = groups.setdefault(r["hw"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "K": set(), "N": set()})
        group["launches"] += r["count"]
        group["K"].add(r["shape"][1])
        group["N"].add(r["shape"][2])
        for key in ("ms", "bound_ms", "library_ms"):
            group[key] += r[key] * r["count"]
    for group in groups.values():
        group["K"], group["N"] = sorted(group["K"]), sorted(group["N"])
    emit({"phase": "image_timing", "per_forward": totals, "conv_mm_bias_relu_by_group": groups,
          "lpips_head_by_tap": [{k: r[k] for k in ("shape", "ms", "f32_ms", "bound_ms")} for r in rows["lpips_head"]],
          "card": smi,
          "at": {"conv": "one InceptionV3 forward, batch 200, bf16",
                 "lpips_head": "one alex LPIPS forward, 50 pairs of 256x256, bf16 maps (f32_*: float32 maps); "
                               "ms: queued_ms (device time), call_ms: median_ms (one call's CUDA events)"}})
    return totals


def phase_attention_vs_plain(torch, ka, dev, gen, path_mask) -> dict:
    """B4 against its plain version: the path's shapes and masks, odd lengths, a narrow head, fully masked rows."""
    hidden, heads = BERT_BASE["hidden_size"], BERT_BASE["num_heads"]
    # (B, L, hidden, heads, rows whose keys are all masked, mask): the path's own masks first, for
    # compute's (2999, 128) and a forward's (100, 128); None draws ragged lengths, as padded sentences
    shapes = [(*path_mask.shape, hidden, heads, 0, path_mask), (100, path_mask.shape[1], hidden, heads, 0, path_mask[:100]),
              (8, 1, hidden, heads, 1, None), (8, 37, hidden, heads, 1, None), (4, 509, hidden, heads, 1, None),
              (16, 50, 96, 4, 2, None)]
    cases, worst = 0, {"f32_abs": 0.0, "f32_rel_to_scale": 0.0, "bf16_abs": 0.0, "masked_row_vs_mean_v": 0.0}
    for bsz, length, hidden, heads, masked, mask in shapes:
        if mask is None:
            lens = torch.randint(max(1, length // 10), length + 1, (bsz,), generator=gen, device=dev)
            mask = (torch.arange(length, device=dev)[None, :] < lens[:, None]).long()
            mask[:masked] = 0
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((bsz, length, hidden), generator=gen, device=dev).to(dtype) for _ in range(3))
            got = ka.attention(q, k, v, mask, num_heads=heads)
            ref = ka.attention_plain(q, k, v, mask, num_heads=heads)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            name = f"B4 ({bsz},{length},{hidden})/{heads} {str(dtype).split('.')[-1]}"
            if dtype == torch.float32:
                check(float(err.max()) <= ATT_F32_RTOL * scale, f"{name}: max abs err {float(err.max())} at scale {scale}")
                worst["f32_abs"] = max(worst["f32_abs"], float(err.max()))
                worst["f32_rel_to_scale"] = max(worst["f32_rel_to_scale"], float(err.max()) / scale)
                if masked:  # the oracle's uniform softmax: the mean of V over the L keys
                    dev_mean = float((got[:masked] - v[:masked].mean(dim=1, keepdim=True)).abs().max())
                    check(dev_mean <= ATT_F32_RTOL * scale, f"{name}: fully masked rows {dev_mean} from mean(V)")
                    worst["masked_row_vs_mean_v"] = max(worst["masked_row_vs_mean_v"], dev_mean)
            else:
                ok = bool((err <= ATT_BF16_ULP * ref.float().abs() + ATT_F32_RTOL * scale).all())
                check(ok, f"{name}: max abs err {float(err.max())} at scale {scale}")
                worst["bf16_abs"] = max(worst["bf16_abs"], float(err.max()))
            cases += 1
            del q, k, v, got, ref, err
    # a view one element into (B, L, hidden + 1) tensors defeats the kernel's 4-element loads: refused, not launched
    q = torch.randn((2, 8, 97), device=dev)[..., 1:]
    launches = int(ka.attention.launches)
    try:
        ka.attention(q, q, q, torch.ones((2, 8), device=dev), num_heads=4)
        refused = False
    except ValueError:
        refused = True
    check(refused and int(ka.attention.launches) == launches, "B4 launched on a view that is not 4-element aligned")
    emit({
        "phase": "attention_vs_plain", "cases": cases, "shapes": [list(sh[:5]) for sh in shapes], "worst": worst,
        "misaligned_view": "refused",
        "tolerance": {
            "float32": f"max|err| <= {ATT_F32_RTOL} * max|ref|, fully masked rows within that of mean(V)",
            "bfloat16": f"|err| <= 2**-7 * |ref| + {ATT_F32_RTOL} * max|ref| (one bf16 rounding step)",
        },
    })
    return {"max_abs_err": max(worst["f32_abs"], worst["bf16_abs"])}


def phase_layernorm_vs_plain(torch, ka, dev, gen, rows: int) -> dict:
    """B5 against its plain version at the path's (rows, 768) and at other widths, float32/bf16 inputs."""
    shapes = [(rows, 768), (1000, 70), (1000, 1000), (1000, 1024), (77, 2000)]
    cases, worst_abs, worst_rel = 0, 0.0, 0.0
    for r, c in shapes:
        for dx, dh in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)):
            x = torch.randn((r, c), generator=gen, device=dev).to(dx)
            h = torch.randn((r, c), generator=gen, device=dev).to(dh)
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = 0.1 * torch.randn(c, generator=gen, device=dev)
            got = ka.layernorm_residual(x, h, scale, bias, eps=1e-12)
            ref = ka.layernorm_residual_plain(x, h, scale, bias, eps=1e-12)
            torch.cuda.synchronize()
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            check(got.dtype == torch.float32 and err <= LN_RTOL * top, f"B5 ({r},{c}) {dx}+{dh}: max abs err {err} at scale {top}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
            cases += 1
    emit({
        "phase": "layernorm_residual_vs_plain", "cases": cases, "shapes": [list(sh) for sh in shapes],
        "inputs": ["f32+f32", "bf16+bf16", "f32+bf16"], "max_abs_err": worst_abs, "max_rel_to_scale": worst_rel,
        "tolerance": f"max|err| <= {LN_RTOL} * max|ref|",
    })
    return {"max_abs_err": worst_abs}


def bert_base_npz(torch, np, seed: int, folder: str) -> str:
    """Seeded random bert-base-uncased weights (with its MLM head) as the JAX package's flat ``.npz``."""
    from torchmetrics_tpu_torch.text._bert_encoder import BertConfig, _BertWithHead, init_bert_weights_
    from torchmetrics_tpu_torch.utilities.convert import bert_variables_from_state_dict, build_on_cpu

    config = BertConfig(**BERT_BASE, with_mlm_head=True)
    net = init_bert_weights_(build_on_cpu(_BertWithHead, config), seed)
    path = os.path.join(folder, "bert_base_uncased.npz")
    np.savez(path, **bert_variables_from_state_dict(net.state_dict(), config))
    return path


def token_corpus(np, rng, pairs: int, width: int, min_len: int, max_len: int, mean_len: float, vocab: int):
    """Pre-tokenized sentence pairs: [CLS] wordpieces [SEP], zero-padded to ``width``; predictions swap ~30% of the wordpieces."""
    lengths = np.clip(np.rint(rng.gamma(4.0, mean_len / 4.0, pairs)), min_len, max_len).astype(np.int64)
    cols = np.arange(width)[None, :]
    mask = (cols < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1000, vocab, (pairs, width)) * mask  # wordpieces; BERT's vocab has its specials below 1000
    ids[:, 0] = SPECIAL_IDS["cls_token_id"]
    ids[np.arange(pairs), lengths - 1] = SPECIAL_IDS["sep_token_id"]
    swap = (rng.random((pairs, width)) < 0.3) & (cols > 0) & (cols < lengths[:, None] - 1)
    pred_ids = np.where(swap, rng.integers(1000, vocab, (pairs, width)), ids)
    return {"input_ids": pred_ids, "attention_mask": mask.copy()}, {"input_ids": ids, "attention_mask": mask}


def phase_bertscore(torch, np, ka, npz: str, corpus, batch: int = 100) -> dict:
    from torchmetrics_tpu_torch.functional.text.bert import _compute_idf, _greedy_cosine_matching, _idf_weights, bert_score
    from torchmetrics_tpu_torch.text import BERTScore
    from torchmetrics_tpu_torch.text._bert_encoder import BertEncoderExtractor

    preds, target = corpus
    n = target["input_ids"].shape[0]
    encoder = BertEncoderExtractor(npz)  # float32, on the card
    encoder(target["input_ids"][:8], target["attention_mask"][:8])  # first call: lazy module loading, not counted
    metric = BERTScore(model=encoder)
    sl = lambda enc, a: {k: v[a:a + batch] for k, v in enc.items()}  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ka.attention.launches.reset()
    ka.layernorm_residual.launches.reset()
    t0 = time.perf_counter()
    forwards = 0
    for u, start in enumerate(range(0, n, batch)):
        if u % 2 == 0:
            metric(sl(preds, start), sl(target, start))  # scores its batch: two encoder forwards
            forwards += 1
        else:
            metric.update(sl(preds, start), sl(target, start))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = (int(ka.attention.launches), int(ka.layernorm_residual.launches))
    out = metric.compute()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"attention": int(ka.attention.launches), "layernorm_residual": int(ka.layernorm_residual.launches)}
    peak = torch.cuda.max_memory_allocated()
    encoder_forwards = 2 * (forwards + 1)
    layers = BERT_BASE["num_layers"]  # one B4 and two B5 per layer of each encoder forward
    check(launches["attention"] == layers * encoder_forwards and launches["layernorm_residual"] == 2 * layers * encoder_forwards,
          f"launches {launches} for {encoder_forwards} encoder forwards")
    compute_launches = [launches["attention"] - before[0], launches["layernorm_residual"] - before[1]]
    check(compute_launches == [2 * layers, 4 * layers], f"compute launched {compute_launches}, expected two forwards")

    idf_metric = BERTScore(model=encoder, idf=True)
    for start in range(0, n, batch):
        idf_metric.update(sl(preds, start), sl(target, start))
    ka.attention.launches.reset()
    ka.layernorm_residual.launches.reset()
    out_idf = idf_metric.compute()
    check([int(ka.attention.launches), int(ka.layernorm_residual.launches)] == [2 * layers, 4 * layers], "idf compute launches")

    # the oracle: the literal unfused float32 graph on the card, scored by the same matcher
    oracle = BertEncoderExtractor(npz, unfused=True)
    dev = encoder.device
    on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pm, tm = on(preds["attention_mask"]), on(target["attention_mask"])
    pe, te = oracle(preds["input_ids"], pm), oracle(target["input_ids"], tm)
    idf_map = _compute_idf(target["input_ids"], target["attention_mask"])
    errs = {}
    for label, got, (pw, tw) in (
        ("idf_off", out, (pm.float(), tm.float())),
        ("idf_on", out_idf, (on(_idf_weights(preds["input_ids"], preds["attention_mask"], idf_map)),
                             on(_idf_weights(target["input_ids"], target["attention_mask"], idf_map)))),
    ):
        want = dict(zip(("precision", "recall", "f1"), _greedy_cosine_matching(pe, pm, te, tm, pw, tw)))
        for key in want:
            check(got[key].shape == (n,) and bool(torch.isfinite(got[key]).all()), f"{label} {key} shape/finite")
        errs[label] = max(float((got[k] - want[k]).abs().max()) for k in want)
        check(errs[label] <= BERTSCORE_ATOL, f"BERTScore {label} vs unfused oracle: {errs[label]}")
    oracle_graphs = {"oracle_graphs": len(oracle.captured.graphs), "oracle_eager_signatures": len(oracle.captured.eager)}
    del oracle, pe, te
    torch.cuda.empty_cache()
    profile = device_time_by_kernel(torch, lambda: bert_score(preds, target, model=encoder), top=8)
    result = {
        "phase": "bertscore_wmt", "pairs": n, "batch": batch, "tokens_per_side": int(target["attention_mask"].sum()),
        "f1_mean": float(out["f1"].mean()), "f1_mean_idf": float(out_idf["f1"].mean()),
        "max_abs_err_vs_unfused": errs, "tolerance": f"|err| <= {BERTSCORE_ATOL} on precision, recall, F1",
        "launches": launches, "encoder_forwards": encoder_forwards, "compute_launches": compute_launches,
        "seconds": t2 - t0, "pairs_per_s": n / (t2 - t0), "updates_seconds": t1 - t0, "compute_seconds": t2 - t1,
        "peak_mem_bytes": peak, "compute_profile": profile,
        # the encoder's graphs of the shapes it met twice and their one pool; the shapes kept eager past its bound
        "trunk_graphs": len(encoder.captured.graphs), "trunk_eager_signatures": len(encoder.captured.eager),
        "trunk_pool_bytes": importlib.import_module("torchmetrics_tpu_torch._compile").pool_bytes(encoder.captured.pool),
        **oracle_graphs,
    }
    emit(result)
    return result


def phase_infolm(torch, np, ka, npz: str, corpus) -> dict:
    from torchmetrics_tpu_torch.functional.text import infolm
    from torchmetrics_tpu_torch.text import InfoLM
    from torchmetrics_tpu_torch.text._bert_encoder import BertMLMExtractor

    preds, target = corpus
    pairs, width = target["input_ids"].shape
    kw = dict(idf=True, information_measure="kl_divergence", temperature=0.25, max_length=width,
              special_tokens_map=SPECIAL_IDS, return_sentence_level_score=True)
    mlm = BertMLMExtractor(npz)
    mlm.logits_at(target["input_ids"][:4], target["attention_mask"][:4], 1)  # first call, not counted
    metric = InfoLM(model=mlm, **kw)
    metric.update(preds, target)
    torch.cuda.synchronize()
    ka.attention.launches.reset()
    ka.layernorm_residual.launches.reset()
    t0 = time.perf_counter()
    corpus_score, sentences = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"attention": int(ka.attention.launches), "layernorm_residual": int(ka.layernorm_residual.launches)}
    layers = BERT_BASE["num_layers"]
    check(launches == {"attention": 2 * width * layers, "layernorm_residual": 4 * width * layers},
          f"InfoLM launches {launches} for 2 sides x {width} positions")
    want_corpus, want = infolm(preds, target, model=BertMLMExtractor(npz, unfused=True), **kw)
    err = float((sentences - want).abs().max())
    check(sentences.shape == (pairs,) and bool(torch.isfinite(sentences).all()), "InfoLM sentence scores")
    check(err <= INFOLM_RTOL * float(want.abs().max()) + INFOLM_ATOL, f"InfoLM vs unfused oracle: {err}")
    result = {
        "phase": "infolm_pairs", "pairs": pairs, "max_length": width, "measure": "kl_divergence", "idf": True,
        "infolm": float(corpus_score), "unfused": float(want_corpus), "max_abs_err_vs_unfused": err,
        "sentence_range": [float(sentences.min()), float(sentences.max())],
        "tolerance": f"|err| <= {INFOLM_RTOL} * max|ref| + {INFOLM_ATOL}",
        "launches": launches, "compute_seconds": seconds, "pairs_per_s": pairs / seconds,
    }
    emit(result)
    return result


def phase_text_timing(torch, ka, dev, gen, mask, smi: str) -> dict:
    """CUDA-event medians of B4 and B5 at one bertscore_wmt forward's shapes, per launch and per forward."""
    import torch.nn.functional as F

    bsz, length = mask.shape
    hidden, heads = BERT_BASE["hidden_size"], BERT_BASE["num_heads"]
    q, k, v = (torch.randn((bsz, length, hidden), generator=gen, device=dev) for _ in range(3))
    split = lambda t: t.view(bsz, length, heads, hidden // heads).transpose(1, 2)  # noqa: E731
    bias4 = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    scale, shift = torch.rand(hidden, generator=gen, device=dev) + 0.5, 0.1 * torch.randn(hidden, generator=gen, device=dev)
    rows = {}
    # B4 float32 runs its products on the tensor cores in three TF32 passes: 3x the operations at the TF32
    # peak, which stays under the bytes; the float32 FMA bound of the earlier kernel is kept beside it
    cost = ka.attention_cost(q, k, v, mask, num_heads=heads)
    att_bound, att_by = bound_ms(dataclasses.replace(cost, flops=3 * cost.flops), TF32_FLOPS_PER_S)
    rows["attention"] = {
        "count": BERT_BASE["num_layers"], "bound_ms": att_bound, "bound_by": att_by,
        "bound_ms_fma": bound_ms(cost, F32_FLOPS_PER_S)[0],
        "ms": median_ms(torch, lambda: ka.attention(q, k, v, mask, num_heads=heads), reps=10),
        "plain_ms": median_ms(torch, lambda: ka.attention_plain(q, k, v, mask, num_heads=heads), reps=3, warmup=1),
        "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=bias4), reps=10),
    }
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    bias4b = bias4.bfloat16()
    rows["attention_bf16"] = {  # compute_dtype=torch.bfloat16; not on the float32 main path
        "count": BERT_BASE["num_layers"],
        **dict(zip(("bound_ms", "bound_by"), bound_ms(ka.attention_cost(qb, kb, vb, mask, num_heads=heads), BF16_FLOPS_PER_S))),
        "ms": median_ms(torch, lambda: ka.attention(qb, kb, vb, mask, num_heads=heads), reps=10),
        "plain_ms": median_ms(torch, lambda: ka.attention_plain(qb, kb, vb, mask, num_heads=heads), reps=3, warmup=1),
        "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(split(qb), split(kb), split(vb), attn_mask=bias4b), reps=10),
    }
    del qb, kb, vb
    ln_bound, ln_by = bound_ms(ka.layernorm_residual_cost(q, k, scale, shift), F32_FLOPS_PER_S)
    rows["layernorm_residual"] = {
        "count": 2 * BERT_BASE["num_layers"], "bound_ms": ln_bound, "bound_by": ln_by,
        "ms": median_ms(torch, lambda: ka.layernorm_residual(q, k, scale, shift, eps=1e-12), reps=20),
        "plain_ms": median_ms(torch, lambda: ka.layernorm_residual_plain(q, k, scale, shift, eps=1e-12), reps=5),
        "library_ms": median_ms(torch, lambda: F.layer_norm(q + k, (hidden,), scale, shift, 1e-12), reps=20),
    }
    per_forward = {
        name: {**{key: r[key] * r["count"] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
               "launches_per_forward": r["count"], "bound_by": r["bound_by"]}
        for name, r in rows.items()
    }
    per_forward["attention"]["bound_ms_fma"] = rows["attention"]["bound_ms_fma"] * rows["attention"]["count"]
    emit({"phase": "text_timing", "per_launch": rows, "per_forward": per_forward, "card": smi,
          "at": f"one bertscore_wmt encoder forward: ({bsz}, {length}, {hidden}), {heads} heads, float32 (attention_bf16: bf16)",
          "bound": {"attention": "max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s TF32); bound_ms_fma: flops / 67 TFLOP/s"},
          "library": {"attention": "F.scaled_dot_product_attention, additive float mask, on head-split views",
                      "layernorm_residual": "F.layer_norm(x + h), two calls"}})
    return per_forward


# ------------------------------------------------------------------ detection
COCO_HW = (480, 640)  # COCO val2017's most common image size (H, W)
SEGM_HW = (427, 640)  # the phase's mask size, also a COCO val2017 size
MAP_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large",
            "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large")
# the card's compute vs the port's CPU compute of the same states: the same float32 arithmetic, the
# curves' sums of 0/1 in float32 (exact), so the summary means agree to their float64 host rounding
MAP_CPU_ATOL = 1e-6
MAP_COCO_ATOL = 1e-5  # vs the numpy pycocotools port (float64 IoUs): the JAX suite's own bbox tolerance
MAP_SEGM_ATOL = 1e-4  # vs the port in segm mode: the JAX suite's own tolerance (float32 mask IoU at ties)
IOU_F64_ATOL = 1e-6  # float32 IoU-family matrices and class means vs float64 numpy on the same boxes
PQ_MEAN_ATOL = 1e-6  # PQ from equal states, card vs CPU: a float32 mean of 133 per-category ratios
TEXT_DEFAULT_ATOL = {"bertscore": 1e-6, "infolm": 1e-5}  # hash encoders, card vs CPU run of the port


def _repo_module(name: str, relpath: str):
    """A numpy-only module of the repo's tests, loaded by its path (no package ``__init__`` runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def coco_val_data(torch, dev, gen, n_img: int, n_cls: int = 80, dets: int = 100, max_gt: int = 50,
                  gt_per_image: int = 0) -> dict:
    """A COCO val2017-shaped detection stream made on the card from the seed.

    ``n_img`` images of 640x480; 1-50 ground truths each, 1 + a geometric law of
    mean ~6.4 (COCO val2017: 36,781 boxes on 5,000 images, 7.36 each), ~1% crowd;
    80 classes under a 1/(k+1)^0.9 law (a few frequent classes, as person is in
    COCO); box sides log-uniform on 6-450 px, so COCO's small (< 32^2), medium and
    large areas are all filled (~39/25/36%); ``dets`` detections an image (COCO's
    maxDets 100): half are jittered copies of a ground truth of their image,
    85% of those with its label, scored higher; the rest anywhere, scored lower.
    ``gt_per_image`` fixes the ground-truth count instead. Returns flat tensors
    and the per-image ground-truth counts (on the host).
    """
    import math

    h, w = COCO_HW
    u = lambda n: torch.rand(n, generator=gen, device=dev)  # noqa: E731
    normal = lambda n: torch.randn(n, generator=gen, device=dev)  # noqa: E731
    n_gt = torch.clamp(1 + torch.floor(-torch.log(u(n_img)) * 6.9), max=max_gt).long()
    if gt_per_image:
        n_gt = torch.full((n_img,), gt_per_image, device=dev)
    probs = (torch.arange(n_cls, device=dev) + 1.0) ** -0.9

    def labels(n):
        return torch.multinomial(probs, n, replacement=True, generator=gen).int()

    def boxes(n):
        side = torch.exp(math.log(6.0) + u(n) * math.log(450.0 / 6.0))
        ratio = torch.exp((u(n) * 2 - 1) * 0.7).sqrt()
        bw, bh = torch.clamp(side * ratio, max=w - 1), torch.clamp(side / ratio, max=h - 1)
        x, y = u(n) * (w - bw), u(n) * (h - bh)
        return torch.stack([x, y, x + bw, y + bh], dim=1)

    total, n_det = int(n_gt.sum()), n_img * dets
    gt_boxes, gt_labels, gt_crowd = boxes(total), labels(total), (u(total) < 0.01).int()
    img = torch.arange(n_det, device=dev) // dets
    pick = (torch.cumsum(n_gt, 0) - n_gt)[img] + torch.floor(u(n_det) * n_gt[img]).long()
    g = gt_boxes[pick]
    gw, gh = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
    cx = (g[:, 0] + g[:, 2]) / 2 + normal(n_det) * 0.1 * gw
    cy = (g[:, 1] + g[:, 3]) / 2 + normal(n_det) * 0.1 * gh
    jw, jh = gw * torch.exp(normal(n_det) * 0.15), gh * torch.exp(normal(n_det) * 0.15)
    x1, y1 = torch.clamp(cx - jw / 2, 0, w - 1), torch.clamp(cy - jh / 2, 0, h - 1)  # inside the image, 1 px at least
    x2 = torch.maximum(torch.clamp(cx + jw / 2, max=w), x1 + 1)
    y2 = torch.maximum(torch.clamp(cy + jh / 2, max=h), y1 + 1)
    jittered = torch.stack([x1, y1, x2, y2], dim=1)
    hit = u(n_det) < 0.5
    return {
        "det_boxes": torch.where(hit[:, None], jittered, boxes(n_det)),
        "det_scores": torch.sigmoid(normal(n_det) + torch.where(hit, 1.0, -1.5)),
        "det_labels": torch.where(hit & (u(n_det) < 0.85), gt_labels[pick], labels(n_det)),
        "gt_boxes": gt_boxes, "gt_labels": gt_labels, "gt_crowd": gt_crowd,
        "gt_counts": n_gt.tolist(), "dets": dets,
    }


def det_batch(data: dict, lo: int, hi: int, geometry: str = "boxes"):
    """Images ``lo:hi`` of a stream as the metric's ``(preds, target)`` lists of per-image dicts (views)."""
    dets, counts = data["dets"], data["gt_counts"]
    start = sum(counts[:lo])
    preds, target = [], []
    for i in range(lo, hi):
        a, b = i * dets, (i + 1) * dets
        preds.append({geometry: data[f"det_{geometry}"][a:b], "scores": data["det_scores"][a:b],
                      "labels": data["det_labels"][a:b]})
        target.append({geometry: data[f"gt_{geometry}"][start:start + counts[i]],
                       "labels": data["gt_labels"][start:start + counts[i]], "iscrowd": data["gt_crowd"][start:start + counts[i]]})
        start += counts[i]
    return preds, target


def on_host(data: dict, lo: int, hi: int) -> dict:
    """Images ``lo:hi`` of a stream as numpy arrays for a worker process; masks stay behind (the host rebuilds them)."""
    start, dets = sum(data["gt_counts"][:lo]), data["dets"]
    stop = start + sum(data["gt_counts"][lo:hi])
    arrays = {k: v for k, v in data.items() if k not in ("gt_counts", "dets") and not k.endswith("_masks")}
    out = {k: v[lo * dets:hi * dets].cpu().numpy() for k, v in arrays.items() if k.startswith("det_")}
    out.update({k: v[start:stop].cpu().numpy() for k, v in arrays.items() if k.startswith("gt_")})
    return {**out, "gt_counts": data["gt_counts"][lo:hi], "dets": dets}


def _host_port_map(arrays: dict, batch: int, threads: int) -> dict:
    """Worker: the port's MeanAveragePrecision on the CPU over the same images in the same updates."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    torch.set_num_threads(threads)
    data = {k: torch.from_numpy(v) if hasattr(v, "dtype") else v for k, v in arrays.items()}
    metric = MeanAveragePrecision(device="cpu")
    n = len(arrays["gt_counts"])
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        metric.update(*det_batch(data, lo, min(lo + batch, n)))
    out = metric.compute()
    return {"stats": {k: float(out[k]) for k in MAP_KEYS}, "seconds": time.perf_counter() - t0}


def rect_masks(xp, params, hw, dev=None):
    """``(n, H, W)`` bool masks, each the union of two integer rectangles ``params[k] = (y0, y1, x0, x1) x 2``.

    ``xp`` is ``torch`` (with ``dev``) or ``numpy``: both give the same bits.
    """
    h, w = hw
    rows = (xp.arange(h) if dev is None else xp.arange(h, device=dev))[None, :, None]
    cols = (xp.arange(w) if dev is None else xp.arange(w, device=dev))[None, None, :]
    p = params[:, :, None, None]
    first = (rows >= p[:, 0]) & (rows < p[:, 1]) & (cols >= p[:, 2]) & (cols < p[:, 3])
    return first | ((rows >= p[:, 4]) & (rows < p[:, 5]) & (cols >= p[:, 6]) & (cols < p[:, 7]))


def segm_data(torch, dev, gen, n_img: int, dets: int = 20, max_gt: int = 10, n_cls: int = 80) -> dict:
    """Mask-detection stream on the card: ``n_img`` 427x640 images, 1-10 ground-truth masks and ``dets`` detections each.

    A mask is the union of two integer rectangles (so the host rebuilds it bit
    for bit from its 8 numbers); a detection is a shifted copy of a ground truth
    of its image (60%, 85% of those with its label) or a mask anywhere.
    """
    h, w = SEGM_HW
    u = lambda n: torch.rand(n, generator=gen, device=dev)  # noqa: E731
    n_gt = torch.randint(1, max_gt + 1, (n_img,), generator=gen, device=dev)
    probs = (torch.arange(n_cls, device=dev) + 1.0) ** -0.9

    def labels(n):
        return torch.multinomial(probs, n, replacement=True, generator=gen).int()

    def params(n):
        out = []
        for _ in range(2):
            bh, bw = (torch.exp(u(n) * 4.5) * 4).long() + 2, (torch.exp(u(n) * 4.5) * 4).long() + 2
            y0, x0 = (u(n) * (h - bh)).long(), (u(n) * (w - bw)).long()
            out += [y0, y0 + bh, x0, x0 + bw]
        return torch.stack(out, dim=1)

    total, n_det = int(n_gt.sum()), n_img * dets
    gt_params, gt_labels = params(total), labels(total)
    img = torch.arange(n_det, device=dev) // dets
    pick = (torch.cumsum(n_gt, 0) - n_gt)[img] + torch.floor(u(n_det) * n_gt[img]).long()
    shift = torch.randint(-6, 7, (n_det, 1), generator=gen, device=dev).repeat(1, 8)
    shift[:, 2:4] = shift[:, 6:8] = torch.randint(-6, 7, (n_det, 1), generator=gen, device=dev)
    jittered = gt_params[pick] + shift
    hit = u(n_det) < 0.6
    det_params = torch.where(hit[:, None], jittered, params(n_det))
    data = {
        "det_params": det_params, "det_scores": torch.sigmoid(torch.randn(n_det, generator=gen, device=dev) + hit * 2.0),
        "det_labels": torch.where(hit & (u(n_det) < 0.85), gt_labels[pick], labels(n_det)),
        "gt_params": gt_params, "gt_labels": gt_labels, "gt_crowd": torch.zeros(total, dtype=torch.int32, device=dev),
        "gt_counts": n_gt.tolist(), "dets": dets,
    }
    data["det_masks"], data["gt_masks"] = rect_masks(torch, det_params, SEGM_HW, dev), rect_masks(torch, gt_params, SEGM_HW, dev)
    return data


def _host_pycocotools(arrays: dict, iou_type: str) -> dict:
    """Worker: the numpy pycocotools port (``tests/unittests/detection/pycocotools_port.py``) on the same images."""
    import numpy as np

    port = _repo_module("pycocotools_port", os.path.join("tests", "unittests", "detection", "pycocotools_port.py"))

    class Params(port.Params):
        """pycocotools' parameters with the metric's thresholds, as torchmetrics sets them for its pycocotools
        backend: ``linspace(...).round(2)``. The unrounded ``linspace`` puts some recall points an ulp off
        the recalls ``k / npig`` that land on them, and moves those samples (~1e-4 in map at 100 images)."""

        def __init__(self):
            super().__init__()
            self.iouThrs = np.linspace(0.5, 0.95, 10).round(2)
            self.recThrs = np.linspace(0.0, 1.00, 101).round(2)

    port.Params = Params
    if iou_type == "segm":
        arrays = {**arrays, "det_masks": rect_masks(np, arrays["det_params"], SEGM_HW),
                  "gt_masks": rect_masks(np, arrays["gt_params"], SEGM_HW)}
    t0 = time.perf_counter()
    preds, target = det_batch(arrays, 0, len(arrays["gt_counts"]), "boxes" if iou_type == "bbox" else "masks")
    stats = port.eval_tm_format(preds, target, iou_type=iou_type)
    return {"stats": {k: float(stats[k]) for k in MAP_KEYS}, "seconds": time.perf_counter() - t0}


def _top_level_imports(relpath: str) -> set:
    """The top-level packages a repo file imports, read from its source."""
    import ast

    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)).read())
    names = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    return {name.split(".")[0] for name in names}


def _max_key_err(got: dict, want: dict) -> float:
    return max(abs(float(got[k]) - float(want[k])) for k in MAP_KEYS)


def phase_detection_coco_val(torch, np, dev, gen, pool, smi: str, n_img: int = 5000, batch: int = 16,
                             subset: int = 500) -> dict:
    """BASELINE config 3: ``MeanAveragePrecision(iou_type="bbox")`` over a COCO val2017-shaped stream on the card.

    The host references start first, in worker processes, and are read at the
    end of the detection phases: the port's own CPU run of the same 5,000
    images in the same updates, and the numpy pycocotools port on the first
    ``subset`` images, which a second metric on the card also evaluates.
    """
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    port_imports = _top_level_imports(os.path.join("tests", "unittests", "detection", "pycocotools_port.py"))
    check(port_imports <= {"__future__", "collections", "numpy"}, f"the pycocotools port imports {port_imports}")
    data = coco_val_data(torch, dev, gen, n_img)
    pending = {"cpu": pool.submit(_host_port_map, on_host(data, 0, n_img), batch, 5),
               "pycocotools": pool.submit(_host_pycocotools, on_host(data, 0, subset), "bbox")}
    metric = MeanAveragePrecision(compute_with_cache=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for lo in range(0, n_img, batch):
        metric.update(*det_batch(data, lo, min(lo + batch, n_img)))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(all(out[k].device == dev and bool(torch.isfinite(out[k])) and -1 <= float(out[k]) <= 1 for k in MAP_KEYS),
          "coco_val: a summary value is off the card, not finite or outside [-1, 1]")
    check(out["classes"].numel() == 80 and 0.05 < float(out["map"]) < 0.95, f"coco_val: map {float(out['map'])}")

    per_class = MeanAveragePrecision(class_metrics=True, compute_with_cache=False)
    per_class.merge_state(metric)  # the same states
    t0 = time.perf_counter()
    pc = per_class.compute()
    torch.cuda.synchronize()
    class_ms = (time.perf_counter() - t0) * 1e3
    valid = pc["map_per_class"] > -1
    pc_err = max(_max_key_err(pc, out), abs(float(pc["map_per_class"][valid].mean()) - float(out["map"])))
    check(pc["map_per_class"].shape == (80,) and pc_err <= MAP_CPU_ATOL, f"coco_val class_metrics: {pc_err}")

    sub = MeanAveragePrecision()
    sub.update(*det_batch(data, 0, subset))
    sub_out = {k: float(v) for k, v in sub.compute().items() if k in MAP_KEYS}
    profile = device_time_by_kernel(torch, metric.compute, top=10)
    gts = sum(data["gt_counts"])
    return {
        "phase": "detection_coco_val", "images": n_img, "classes": 80, "detections": n_img * data["dets"],
        "ground_truths": gts, "crowd": int(data["gt_crowd"].sum()), "batch": batch,
        "results": {k: float(out[k]) for k in MAP_KEYS}, "subset_results": sub_out, "pending": pending,
        "max_err": {"class_metrics_run": pc_err},
        "seconds": stream_s, "images_per_s": n_img / stream_s, "update_ms": stream_s / -(-n_img // batch) * 1e3,
        "compute_ms": compute_ms, "class_metrics_compute_ms": class_ms, "peak_mem_bytes": peak,
        "compute_profile": profile, "card": smi,
    }


def phase_detection_stream(torch, dev, gen, n_updates: int = 1000) -> dict:
    """The JAX package's old streaming shape: 1 image an update, 100 detections and 20 ground truths."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    data = coco_val_data(torch, dev, gen, n_updates, gt_per_image=20)
    metric, whole = MeanAveragePrecision(), MeanAveragePrecision()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_updates):
        metric.update(*det_batch(data, i, i + 1))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    whole.update(*det_batch(data, 0, n_updates))  # the same images in one update: the same states
    err = _max_key_err(whole.compute(), out)
    check(err <= MAP_CPU_ATOL, f"detection_stream: one update vs {n_updates} updates: {err}")
    return {"phase": "detection_stream", "updates": n_updates, "detections_per_image": data["dets"],
            "ground_truths_per_image": 20, "map": float(out["map"]), "max_err_vs_one_update": err,
            "seconds": stream_s, "updates_per_s": n_updates / stream_s, "compute_ms": compute_ms}


def phase_detection_segm(torch, np, dev, gen, pool, n_img: int = 100, batch: int = 10) -> dict:
    """``MeanAveragePrecision(iou_type="segm")`` on 100 images of 427x640 masks; the masks round-trip through COCO json."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    data = segm_data(torch, dev, gen, n_img)
    pending = {"pycocotools": pool.submit(_host_pycocotools, on_host(data, 0, n_img), "segm")}
    metric = MeanAveragePrecision(iou_type="segm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_img, batch):
        metric.update(*det_batch(data, lo, lo + batch, "masks"))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as folder:
        name = os.path.join(folder, "segm")
        t0 = time.perf_counter()
        metric.tm_to_coco(name)
        preds, target = MeanAveragePrecision.coco_to_tm(f"{name}_preds.json", f"{name}_target.json", iou_type="segm")
        round_trip_s = time.perf_counter() - t0
    masks = 0
    for i in range(n_img):
        for side, entry in (("preds", preds[i]), ("target", target[i])):
            want = (metric.detection_mask if side == "preds" else metric.groundtruth_mask)[i].cpu().numpy()
            check(np.array_equal(entry["masks"].numpy().astype(bool), want), f"segm round trip: image {i} {side} masks")
            masks += len(want)
    return {"phase": "detection_segm", "images": n_img, "mask_hw": list(SEGM_HW), "detections": n_img * data["dets"],
            "ground_truths": sum(data["gt_counts"]), "results": {k: float(out[k]) for k in MAP_KEYS},
            "pending": pending, "round_trip": {"masks": masks, "exact": True, "seconds": round_trip_s},
            "seconds": stream_s, "compute_ms": compute_ms}


def _f64_box_family(np, a, b):
    """IoU, GIoU, DIoU and CIoU matrices of ``xyxy`` boxes in float64, written from their definitions."""
    a, b = a.astype(np.float64)[:, None, :], b.astype(np.float64)[None, :, :]
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
    inter = (np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
             * np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0, None))
    union = area(a) + area(b) - inter
    iou = inter / union
    ew = np.maximum(a[..., 2], b[..., 2]) - np.minimum(a[..., 0], b[..., 0])
    eh = np.maximum(a[..., 3], b[..., 3]) - np.minimum(a[..., 1], b[..., 1])
    giou = iou - (ew * eh - union) / (ew * eh)
    centre = ((a[..., 0] + a[..., 2] - b[..., 0] - b[..., 2]) ** 2 + (a[..., 1] + a[..., 3] - b[..., 1] - b[..., 3]) ** 2) / 4
    diou = iou - centre / (ew**2 + eh**2)
    atan = lambda x: np.arctan((x[..., 2] - x[..., 0]) / (x[..., 3] - x[..., 1]))  # noqa: E731
    v = 4 / np.pi**2 * (atan(a) - atan(b)) ** 2
    return {"intersection_over_union": iou, "generalized_intersection_over_union": giou,
            "distance_intersection_over_union": diou, "complete_intersection_over_union": diou - v / (1 - iou + v) * v}


def panoptic_maps(torch, dev, gen, n: int, side: int = 512, things=range(1, 81), stuffs=range(92, 145)):
    """COCO-panoptic-like ``(n, side, side, 2)`` maps: a 16x16 grid of stuff regions, ~15 thing instances painted
    over it, ~4% void (category 0, unknown); the prediction moves each instance a few pixels, relabels 10% of
    the stuff cells and 10% of the instances, and drops or invents a few."""
    things, stuffs = torch.tensor(list(things), device=dev), torch.tensor(list(stuffs), device=dev)
    pick = lambda pool, shape: pool[torch.randint(0, len(pool), shape, generator=gen, device=dev)]  # noqa: E731
    grid = pick(stuffs, (n, 16, 16))
    noisy_grid = torch.where(torch.rand((n, 16, 16), generator=gen, device=dev) < 0.1, pick(stuffs, (n, 16, 16)), grid)
    cell = side // 16
    rows = torch.arange(side, device=dev)[None, :, None]
    cols = torch.arange(side, device=dev)[None, None, :]
    k = 15
    y0 = torch.randint(0, side - 40, (n, k), generator=gen, device=dev)
    x0 = torch.randint(0, side - 40, (n, k), generator=gen, device=dev)
    hh = torch.randint(16, 160, (n, k), generator=gen, device=dev)
    ww = torch.randint(16, 160, (n, k), generator=gen, device=dev)
    cat = pick(things, (n, k))
    dy, dx = (torch.randint(-4, 5, (n, k), generator=gen, device=dev) for _ in range(2))
    relabel = torch.rand((n, k), generator=gen, device=dev) < 0.1
    keep = torch.rand((n, k), generator=gen, device=dev) < 0.9
    pred_cat = torch.where(relabel, pick(things, (n, k)), cat)

    def paint(stuff_grid, cats, ys, xs, present):
        c = stuff_grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        inst = torch.zeros_like(c)
        for j in range(k):
            inside = ((rows >= ys[:, j, None, None]) & (rows < (ys + hh)[:, j, None, None]) & (cols >= xs[:, j, None, None])
                      & (cols < (xs + ww)[:, j, None, None]) & present[:, j, None, None])
            c = torch.where(inside, cats[:, j, None, None], c)
            inst = torch.where(inside, j + 1, inst)
        return torch.stack([c, inst], dim=-1)

    target = paint(grid, cat, y0, x0, torch.ones_like(keep))
    void = torch.rand((n, 16, 16), generator=gen, device=dev).repeat_interleave(cell, 1).repeat_interleave(cell, 2) < 0.04
    target[..., 0] = torch.where(void, 0, target[..., 0])
    preds = paint(noisy_grid, pred_cat, y0 + dy, x0 + dx, keep)
    return preds, target, set(range(1, 81)), set(range(92, 145))


def phase_iou_panoptic(torch, np, dev, gen) -> dict:
    """The IoU family on 16 images of 100 x 100 boxes against float64 numpy, and PQ / modified PQ on 8 COCO-panoptic-like
    512x512 maps against the port's CPU run (exactly) and the golden cases 162/163."""
    import torchmetrics_tpu_torch as tt
    import torchmetrics_tpu_torch.functional as F

    n_img, n_box, n_cls = 16, 100, 5
    xy = torch.rand((2, n_img, n_box, 2), generator=gen, device=dev) * 100
    boxes = torch.cat([xy, xy + torch.rand((2, n_img, n_box, 2), generator=gen, device=dev) * 30 + 2], dim=-1)
    labels = torch.randint(0, n_cls, (2, n_img, n_box), generator=gen, device=dev)
    host_boxes, host_labels = boxes.cpu().numpy(), labels.cpu().numpy()
    classes = {"intersection_over_union": tt.IntersectionOverUnion, "generalized_intersection_over_union":
               tt.GeneralizedIntersectionOverUnion, "distance_intersection_over_union": tt.DistanceIntersectionOverUnion,
               "complete_intersection_over_union": tt.CompleteIntersectionOverUnion}
    errs, results = {}, {}
    refs = [_f64_box_family(np, host_boxes[0, i], host_boxes[1, i]) for i in range(n_img)]
    for name, cls in classes.items():
        err = 0.0
        for i in range(n_img):
            mat = getattr(F, name)(boxes[0, i], boxes[1, i], aggregate=False)
            err = max(err, float(np.abs(mat.cpu().numpy() - refs[i][name]).max()))
        metric = cls(class_metrics=True)
        metric.update([{"boxes": boxes[0, i], "labels": labels[0, i]} for i in range(n_img)],
                      [{"boxes": boxes[1, i], "labels": labels[1, i]} for i in range(n_img)])
        got = metric.compute()
        same = [host_labels[0, i][:, None] == host_labels[1, i][None, :] for i in range(n_img)]
        want = {metric._iou_type: np.concatenate([refs[i][name][same[i]] for i in range(n_img)]).mean()}
        for c in range(n_cls):
            col = [refs[i][name][:, host_labels[1, i] == c][same[i][:, host_labels[1, i] == c]] for i in range(n_img)]
            want[f"{metric._iou_type}/cl_{c}"] = np.concatenate(col).mean()
        check(sorted(got) == sorted(want), f"{name}: keys {sorted(got)}")
        err = max(err, *(abs(float(got[k]) - want[k]) for k in want))
        check(err <= IOU_F64_ATOL, f"{name} vs float64: {err}")
        errs[name], results[metric._iou_type] = err, float(got[metric._iou_type])

    preds, target, things, stuffs = panoptic_maps(torch, dev, gen, 8)
    pq_out = {}
    for cls in (tt.PanopticQuality, tt.ModifiedPanopticQuality):
        card, host = cls(things=things, stuffs=stuffs), cls(things=things, stuffs=stuffs, device="cpu")
        t0 = time.perf_counter()
        for lo in (0, 4):
            card.update(preds[lo:lo + 4], target[lo:lo + 4])
        value = card.compute()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for lo in (0, 4):
            host.update(preds[lo:lo + 4].cpu(), target[lo:lo + 4].cpu())
        for state in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            check(torch.equal(getattr(card, state).cpu(), getattr(host, state)), f"{cls.__name__} {state}: card != CPU")
        # equal states; the mean over the 133 categories is a float32 sum in the device's own order
        diff = abs(float(value) - float(host.compute()))
        check(diff <= PQ_MEAN_ATOL and 0.1 < float(value) < 1.0, f"{cls.__name__} {float(value)}, vs CPU {diff}")
        pq_out[cls.__name__] = {"value": float(value), "diff_vs_cpu": diff, "ms": ms}

    specs = _repo_module("golden_specs", os.path.join("tests", "helpers", "golden_specs.py")).SPECS
    pack = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "goldens.npz"))
    golden_err = {}
    for idx in (158, 159, 160, 161, 162, 163):
        spec = specs[idx]
        got = getattr(F, spec.fn)(*[torch.from_numpy(a).to(dev) for a in spec.make()], **spec.kwargs)
        want = pack[f"{idx:03d}_{spec.fn}/0"].astype(np.float64)
        golden_err[idx] = float(abs(got.double().cpu().numpy() - want).max())
        check(np.allclose(got.double().cpu().numpy(), want, atol=spec.atol, rtol=1e-4), f"golden {idx} {spec.fn}: {golden_err[idx]}")
    out = {"phase": "iou_panoptic", "boxes": [n_img, n_box, n_box], "results": results, "max_abs_err_vs_float64": errs,
           "tolerance": IOU_F64_ATOL, "panoptic": {"maps": list(preds.shape), "things": len(things), "stuffs": len(stuffs),
           **pq_out, "check": f"states equal to the CPU run, value within {PQ_MEAN_ATOL}"}, "golden_max_err": golden_err}
    emit(out)
    return out


def finish_detection(coco: dict, segm: dict, t_start: float) -> None:
    """Read the detection phases' host references (worker processes), check them, and print the phases' lines.

    ``t_start`` is when phases 17-21 began: their wall time, waits included, goes on the coco_val line.
    """
    pending = coco.pop("pending")
    cpu, ref = pending["cpu"].result(), pending["pycocotools"].result()
    cpu_err = _max_key_err(cpu["stats"], coco["results"])
    check(cpu_err <= MAP_CPU_ATOL, f"coco_val: card vs the port's CPU run: {cpu_err}")
    ref_err = _max_key_err(ref["stats"], coco.pop("subset_results"))
    check(ref_err <= MAP_COCO_ATOL, f"coco_val subset vs the pycocotools port: {ref_err}")
    coco["max_err"].update(cpu_run=cpu_err, pycocotools_port_subset=ref_err)
    coco["tolerance"] = {"cpu_run": MAP_CPU_ATOL, "pycocotools_port_subset": MAP_COCO_ATOL,
                         "class_metrics_run": MAP_CPU_ATOL}
    coco["host_seconds"] = {"cpu_run": cpu["seconds"], "pycocotools_port_subset": ref["seconds"]}
    coco["phases_17_21_seconds"] = time.perf_counter() - t_start
    emit(coco)
    ref = segm.pop("pending")["pycocotools"].result()
    err = _max_key_err(ref["stats"], segm["results"])
    check(err <= MAP_SEGM_ATOL, f"segm vs the pycocotools port: {err}")
    segm["results"] = {k: segm["results"][k] for k in ("map", "map_50", "map_75", "mar_100")}
    segm.update(max_err_vs_pycocotools_port=err, tolerance=MAP_SEGM_ATOL, host_seconds=ref["seconds"])
    emit(segm)


def _host_text_no_model(kind: str, preds: dict, target: dict) -> dict:
    """Worker: BERTScore() or InfoLM() without a model on the CPU: its token-id states and its scores."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    torch.set_num_threads(2)
    metric = BERTScore(device="cpu") if kind == "bertscore" else InfoLM(device="cpu", return_sentence_level_score=True)
    metric.update(preds, target)
    out = metric.compute()
    scores = out["f1"] if kind == "bertscore" else out[1]
    return {"ids": [torch.cat(getattr(metric, f"{side}_input_ids")).numpy() for side in ("preds", "target")],
            "scores": scores.numpy()}


def submit_text_no_model(pool, corpora: dict, pairs: int = 64) -> dict:
    """Start the CPU runs of the no-model text metrics on the first ``pairs`` pairs of each corpus."""
    head = lambda enc: {k: v[:pairs] for k, v in enc.items()}  # noqa: E731
    return {kind: pool.submit(_host_text_no_model, kind, head(preds), head(target))
            for kind, (preds, target) in corpora.items()}


def phase_text_no_model(torch, np, corpora: dict, pending: dict, pairs: int = 64) -> None:
    """``BERTScore()`` and ``InfoLM()`` built without a model (the hash encoders) on the card, against the CPU run."""
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    out = {"phase": "text_no_model", "pairs": pairs}
    for kind, (preds, target) in corpora.items():
        metric = BERTScore() if kind == "bertscore" else InfoLM(return_sentence_level_score=True)
        head = lambda enc: {k: v[:pairs] for k, v in enc.items()}  # noqa: E731
        metric.update(head(preds), head(target))
        t0 = time.perf_counter()
        res = metric.compute()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        scores = res["f1"] if kind == "bertscore" else res[1]
        host = pending[kind].result()
        for side, want in zip(("preds", "target"), host["ids"]):
            check(np.array_equal(torch.cat(getattr(metric, f"{side}_input_ids")).cpu().numpy(), want), f"{kind} {side} ids")
        err = float(np.abs(scores.cpu().numpy() - host["scores"]).max())
        check(scores.shape == (pairs,) and bool(torch.isfinite(scores).all()), f"{kind} no-model scores")
        check(err <= TEXT_DEFAULT_ATOL[kind], f"{kind} no model, card vs CPU: {err}")
        out[kind] = {"corpus": "bertscore_wmt" if kind == "bertscore" else "infolm_pairs", "mean": float(scores.mean()),
                     "max_abs_err_vs_cpu": err, "tolerance": TEXT_DEFAULT_ATOL[kind], "ids": "exact", "compute_ms": ms}
    emit(out)


# ------------------------------------------------------- the text family without a model (phases 22-27)
TEXT_RATE_RTOL = 1e-6  # edit-family rates: one float32 division of exact counts, against float64
ROUGE_F64_ATOL = 1e-6  # float32 means of 11,490 float64 per-pair scores in [0, 1], against a float64 mean
MT_RTOL = 1e-6  # BLEU/chrF/TER/EED, card vs the port's CPU run: the same host counts, float32 math on each device
PPL_F64_RTOL = 1e-4  # perplexity against a float64 log-softmax: float32 log-softmax rows and a 294,912-term float32 sum
PPL_VOCAB = 50257  # GPT-2's vocabulary


def zipf_vocabulary(np, rng, size: int, alphabet: str, mean_len: float):
    """``size`` distinct words of ``alphabet`` (mean length ``mean_len``) and Zipf weights over their ranks."""
    letters = np.array(list(alphabet))
    words, seen = [], set()
    while len(words) < size:
        word = "".join(rng.choice(letters, 1 + int(rng.poisson(mean_len - 1))))
        if word not in seen:
            seen.add(word)
            words.append(word)
    weights = 1.0 / (np.arange(size) + 2.7) ** 1.07
    return words, weights / weights.sum()


def split_lengths(np, rng, n: int, total: int, log_mean: float, sigma: float, lo: int, hi: int):
    """``n`` lognormal lengths in ``[lo, hi]`` moved one at a time until they sum to ``total``."""
    lengths = np.clip(np.rint(rng.lognormal(log_mean, sigma, n)), lo, hi).astype(np.int64)
    while lengths.sum() != total:
        step = 1 if lengths.sum() < total else -1
        i = int(rng.integers(0, n))
        lengths[i] = min(hi, max(lo, lengths[i] + step))
    return lengths


def asr_corpus(np, rng, n: int = 2620, n_words: int = 52_576):
    """LibriSpeech test-clean's shape: ``n`` uppercase references of 1-90 words (``n_words`` in all, ~108
    characters an utterance) from a Zipf vocabulary; hypotheses with ~3% substitutions, 1% deletions and
    1% insertions a word."""
    words, weights = zipf_vocabulary(np, rng, 8000, "ABCDEFGHIJKLMNOPQRSTUVWXYZ", 4.4)
    lengths = split_lengths(np, rng, n, n_words, np.log(16.0), 0.65, 1, 90)
    ids = rng.choice(len(words), n_words, p=weights)
    subs = rng.choice(len(words), n_words, p=weights)
    inserts = rng.choice(len(words), n_words, p=weights)
    u, ins = rng.random(n_words), rng.random(n_words) < 0.01
    preds, target, k = [], [], 0
    for length in lengths:
        ref, hyp = [], []
        for j in range(k, k + length):
            ref.append(words[ids[j]])
            if u[j] >= 0.04:
                hyp.append(words[ids[j]])
            elif u[j] < 0.03:
                hyp.append(words[subs[j]])
            if ins[j]:
                hyp.append(words[inserts[j]])
        preds.append(" ".join(hyp))
        target.append(" ".join(ref))
        k += length
    return preds, target


class WordPool:
    """Zipf draws over a vocabulary, made in one call and handed out in order (wrapping at the end)."""

    def __init__(self, np, rng, words: list, weights, size: int):
        self.np, self.words, self.k = np, words, 0
        self.ids = rng.choice(len(words), size, p=weights)

    def take(self, n: int) -> list:
        ids = self.np.take(self.ids, range(self.k, self.k + n), mode="wrap")
        self.k += n
        return [self.words[i] for i in ids]


def _sentences(rng, words: list, n_sentences: int, abbreviations: list) -> str:
    """``words`` cut into ``n_sentences`` sentences: capitalized, ended by ``.``, ``!`` or ``?``, some with an abbreviation."""
    cuts = sorted(rng.choice(range(1, len(words)), min(n_sentences, len(words)) - 1, replace=False).tolist())
    out = []
    for lo, hi in zip([0] + cuts, cuts + [len(words)]):
        part = words[lo:hi]
        if rng.random() < 0.2 and len(part) > 2:
            part.insert(int(rng.integers(1, len(part))), abbreviations[int(rng.integers(0, len(abbreviations)))])
        part[0] = part[0].capitalize()
        out.append(" ".join(part) + "...!?"[min(4, int(rng.integers(0, 5)))])
    return " ".join(out)


def cnndm_corpus(np, rng, n: int = 11_490):
    """CNN/DailyMail test's shape: highlights of ~56 words in ~3.75 sentences; candidates of ~60 words that keep
    ~40% of the reference's words in order, the rest from the vocabulary, in ~4 sentences."""
    pool = WordPool(np, rng, *zipf_vocabulary(np, rng, 20_000, "abcdefghijklmnopqrstuvwxyz", 5.0), 1 << 21)
    abbreviations = ["Dr. Smith", "Mr. Jones", "U.S. officials", "e.g. police", "St. Louis", "Gen. Lee", "Jan. 5"]
    preds, target = [], []
    for _ in range(n):
        ref = pool.take(int(np.clip(rng.normal(56, 14), 12, 120)))
        kept = [w for w, u in zip(ref, rng.random(len(ref))) if u < 0.4]
        total = max(len(kept) + 1, int(np.clip(rng.normal(60, 12), 15, 120)))
        slots = np.zeros(total, bool)
        slots[rng.choice(total, len(kept), replace=False)] = True
        fresh, old = iter(pool.take(total - len(kept))), iter(kept)
        cand = [next(old) if slot else next(fresh) for slot in slots]
        target.append(_sentences(rng, ref, 1 + int(rng.poisson(2.75)), abbreviations))
        preds.append(_sentences(rng, cand, 1 + int(rng.poisson(3.0)), abbreviations))
    return preds, target


def wmt_corpus(np, rng, n: int = 2999):
    """WMT16 newstest2016's size at bertscore_wmt's lengths (8-77 words, ~30): mixed case, commas, numbers and a final
    period; hypotheses with 15% substituted, 5% deleted and 5% inserted words and, in 30% of them, a moved span."""
    pool = WordPool(np, rng, *zipf_vocabulary(np, rng, 30_000, "abcdefghijklmnopqrstuvwxyz", 5.2), 1 << 18)
    preds, target = [], []
    for _ in range(n):
        ref = pool.take(int(np.clip(np.rint(rng.gamma(4.0, 7.5)), 8, 77)))
        u, extra = rng.random((2, len(ref)))
        ref = [f"{w}," if a < 0.06 else (f"{int(b * 998) + 1},{int(b * 899) + 100}" if a > 0.98 else w)
               for w, a, b in zip(ref, u, extra)]
        ref[0] = ref[0].capitalize()
        subs, inserts = iter(pool.take(len(ref))), iter(pool.take(len(ref)))
        hyp = []
        for w, a, b in zip(ref, rng.random(len(ref)), rng.random(len(ref))):
            if a < 0.15:
                hyp.append(next(subs))
            elif a >= 0.2:
                hyp.append(w)
            if b < 0.05:
                hyp.append(next(inserts))
        if rng.random() < 0.3 and len(hyp) > 8:
            i, k = int(rng.integers(0, len(hyp) - 5)), int(rng.integers(2, 6))
            span, rest = hyp[i:i + k], hyp[:i] + hyp[i + k:]
            j = int(rng.integers(0, len(rest) + 1))
            hyp = rest[:j] + span + rest[j:]
        preds.append(" ".join(hyp) + " .")
        target.append(" ".join(ref) + ".")
    return preds, target


def squad_corpus(np, rng, n: int = 10_570):
    """SQuAD v1.1 dev's shape: ``n`` questions with 1-3 answers of 1-6 words; 60% of the predictions are an answer,
    some recased or with an article or punctuation added, the rest a span of the context's words."""
    pool = WordPool(np, rng, *zipf_vocabulary(np, rng, 12_000, "abcdefghijklmnopqrstuvwxyz", 5.5), 1 << 17)
    preds, target = [], []
    for q in range(n):
        first = pool.take(int(rng.integers(1, 7)))
        answers = [" ".join(first)]
        for _ in range(int(rng.integers(0, 3))):
            k = int(rng.integers(0, len(first)))
            answers.append(" ".join(first[k:] if rng.random() < 0.5 else first[:k + 1]))
        if rng.random() < 0.6:
            guess = answers[int(rng.integers(0, len(answers)))]
            guess = guess.upper() if rng.random() < 0.2 else (f"the {guess}." if rng.random() < 0.3 else guess)
        else:
            guess = " ".join(first[: int(rng.integers(1, len(first) + 1))] + pool.take(int(rng.integers(0, 4))))
        qid = f"{q:024x}"
        preds.append({"prediction_text": guess, "id": qid})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": qid})
    return preds, target


def _plain_levenshtein(a, b) -> int:
    """Textbook Levenshtein DP, one pair (the host reference of the edit family)."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def _host_asr_reference(preds: list, target: list) -> dict:
    """Worker: word- and character-level Levenshtein distances of each pair, plain Python."""
    return {"words": [_plain_levenshtein(p.split(), t.split()) for p, t in zip(preds, target)],
            "chars": [_plain_levenshtein(p, t) for p, t in zip(preds, target)]}


def _host_edit_dispatch(cases: dict) -> dict:
    """Worker: the port's host DP route (``_edit_distance_tokens`` below the dispatch size) timed on each case."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    helper = importlib.import_module("torchmetrics_tpu_torch.functional.text.helper")
    helper._HOST_DISPATCH_MAX_CELLS = 1 << 62
    out = {}
    for key, (preds, target) in cases.items():
        reps = 5 if len(preds) <= 32 else 1
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            helper._edit_distance_tokens(preds, target, device="cpu")
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = statistics.median(times)
    return out


_ROUGE_TOKEN = re.compile(r"[^a-z0-9]+")


def _plain_lcs(a, b) -> int:
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def _host_rouge_reference(preds: list, target: list) -> dict:
    """Worker: float64 ROUGE-1/2/L precision, recall and F of each pair from n-gram counters and an LCS DP, plain Python."""
    def prf(hits, n_pred, n_ref):
        if not n_pred or not n_ref or not hits:
            return 0.0, 0.0, 0.0
        p, r = hits / n_pred, hits / n_ref
        return p, r, 2 * p * r / (p + r)

    scores, lcs = {"1": [], "2": [], "L": []}, []
    for pred, ref in zip(preds, target):
        a, b = _ROUGE_TOKEN.sub(" ", pred.lower()).split(), _ROUGE_TOKEN.sub(" ", ref.lower()).split()
        for n in (1, 2):
            grams_a = collections.Counter(tuple(a[i:i + n]) for i in range(len(a) - n + 1))
            grams_b = collections.Counter(tuple(b[i:i + n]) for i in range(len(b) - n + 1))
            scores[str(n)].append(prf(sum((grams_a & grams_b).values()), max(0, len(a) - n + 1), max(0, len(b) - n + 1)))
        lcs.append(_plain_lcs(a, b))
        scores["L"].append(prf(lcs[-1], len(a), len(b)))
    return {"scores": scores, "lcs": lcs}


def _host_rouge_lsum(preds: list, target: list, batch: int) -> list:
    """Worker: the port's ``ROUGEScore`` on the CPU, ROUGE-Lsum only, over the same updates: each pair's F."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.text import ROUGEScore

    torch.set_num_threads(1)
    metric = ROUGEScore(rouge_keys="rougeLsum", device="cpu")
    for lo in range(0, len(preds), batch):
        metric.update(preds[lo:lo + batch], target[lo:lo + batch])
    return torch.cat(metric.rougeLsum_fmeasure).tolist()


def wmt_metrics(device) -> dict:
    """The MT metrics of phase ``wmt_mt``, on ``device``."""
    from torchmetrics_tpu_torch.text import (
        BLEUScore, CHRFScore, ExtendedEditDistance, SacreBLEUScore, TranslationEditRate,
    )

    return {
        "bleu": BLEUScore(device=device), "sacrebleu_13a": SacreBLEUScore(tokenize="13a", device=device),
        "sacrebleu_intl": SacreBLEUScore(tokenize="intl", device=device),
        "chrf": CHRFScore(n_word_order=0, device=device), "chrf_pp": CHRFScore(n_word_order=2, device=device),
        "ter": TranslationEditRate(return_sentence_level_score=True, device=device),
        "eed": ExtendedEditDistance(return_sentence_level_score=True, device=device),
    }


def _mt_result(metric) -> dict:
    """A metric's states (list states flattened) and its result, as host floats."""
    host = lambda v: v.cpu().numpy().reshape(-1).tolist()  # noqa: E731
    states = {k: [x for t in v for x in host(t)] if isinstance(v, list) else host(v) for k, v in metric.metric_state.items()}
    out = metric.compute()
    score, sentence = out if isinstance(out, tuple) else (out, None)
    return {"states": states, "score": float(score), "sentence": None if sentence is None else host(sentence)}


def _host_wmt(names: list, preds: list, target: list, batch: int) -> dict:
    """Worker: the port's MT metrics ``names`` on the CPU over the same updates: states and scores."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    metrics = {k: v for k, v in wmt_metrics("cpu").items() if k in names}
    for lo in range(0, len(preds), batch):
        for metric in metrics.values():
            metric.update(preds[lo:lo + batch], [[t] for t in target[lo:lo + batch]])
    return {k: _mt_result(m) for k, m in metrics.items()}


def _host_squad(preds: list, target: list, batch: int) -> dict:
    """Worker: the port's ``SQuAD`` on the CPU over the same updates."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.text import SQuAD

    metric = SQuAD(device="cpu")
    for lo in range(0, len(preds), batch):
        metric.update(preds[lo:lo + batch], target[lo:lo + batch])
    return {"states": {k: float(v) for k, v in metric.metric_state.items()},
            "result": {k: float(v) for k, v in metric.compute().items()}}


def kernel_counters(kernel, ce, lh, ka) -> dict:
    """The launch counters of B1-B5's wrappers, by name."""
    return {"confmat": kernel.confusion_matrix_cuda, "matmul_bias_relu": ce.matmul_bias_relu,
            "bias_relu_": ce.bias_relu_, "lpips_head": lh.lpips_head, "attention": ka.attention,
            "layernorm_residual": ka.layernorm_residual}


class DPRoutes:
    """Counts the edit family's and ROUGE-L's calls of the batched device DP (the host route is every other call)."""

    def __init__(self):
        self.helper = importlib.import_module("torchmetrics_tpu_torch.functional.text.helper")
        self.calls = []
        self._originals = {}

    def __enter__(self):
        for name in ("_levenshtein_batch", "_lcs_batch"):
            original = self._originals[name] = getattr(self.helper, name)

            def counted(*args, _name=name, _original=original, **kwargs):
                self.calls.append({"dp": _name, "pairs": int(args[0].shape[0]),
                                   "padded_cells": int(args[0].shape[0] * args[4] * args[2].shape[1])})
                return _original(*args, **kwargs)

            setattr(self.helper, name, counted)
        return self

    def __exit__(self, *exc):
        for name, original in self._originals.items():
            setattr(self.helper, name, original)


def text_chunks(n: int, parts: int, align: int = 1) -> list:
    """``parts`` contiguous ranges covering ``n``, each boundary a multiple of ``align``."""
    step = -(-n // (parts * align)) * align
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def submit_text_references(pool, corpora: dict) -> dict:
    """Start the host references of phases 22-27 in the worker pool; read at the end of each phase."""
    asr_p, asr_t = corpora["asr"]
    cnn_p, cnn_t = corpora["cnndm"]
    wmt_p, wmt_t = corpora["wmt"]
    sq_p, sq_t = corpora["squad"]
    pending = {
        "asr": [pool.submit(_host_asr_reference, asr_p[lo:hi], asr_t[lo:hi]) for lo, hi in text_chunks(len(asr_p), 4)],
        "rouge": [pool.submit(_host_rouge_reference, cnn_p[lo:hi], cnn_t[lo:hi]) for lo, hi in text_chunks(len(cnn_p), 4)],
        "rouge_lsum": [pool.submit(_host_rouge_lsum, cnn_p[lo:hi], cnn_t[lo:hi], 64)
                       for lo, hi in text_chunks(len(cnn_p), 4, 64)],
        "wmt": [pool.submit(_host_wmt, names, wmt_p, wmt_t, 100)
                for names in (["ter"], ["eed"], ["bleu", "sacrebleu_13a", "sacrebleu_intl", "chrf", "chrf_pp"])],
        "squad": pool.submit(_host_squad, sq_p, sq_t, 1000),
    }
    return pending


def edit_dispatch_cases(corpus, batches=(1, 4, 32, 256, 2620)) -> dict:
    """The first ``b`` LibriSpeech-shaped pairs, tokenized into words and characters, for each batch ``b``."""
    preds, target = corpus
    cases = {}
    for b in batches:
        cases[f"word_{b}"] = ([p.split() for p in preds[:b]], [t.split() for t in target[:b]])
        cases[f"char_{b}"] = ([list(p) for p in preds[:b]], [list(t) for t in target[:b]])
    return cases


def phase_librispeech_asr(torch, np, corpus, pending: list, smi: str, batch: int = 32) -> dict:
    """WER, CER, MER, WIL, WIP and character ``EditDistance`` as one ``MetricCollection`` in updates of ``batch``, then
    each functional over the whole corpus: counts exact against plain-Python Levenshtein, rates within 1e-6."""
    import torchmetrics_tpu_torch.functional.text as F
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.text import (
        CharErrorRate, EditDistance, MatchErrorRate, WordErrorRate, WordInfoLost, WordInfoPreserved,
    )

    preds, target = corpus
    n = len(preds)
    mc = MetricCollection({"wer": WordErrorRate(), "cer": CharErrorRate(), "mer": MatchErrorRate(),
                           "wil": WordInfoLost(), "wip": WordInfoPreserved(), "edit": EditDistance()})
    torch.cuda.synchronize()
    with DPRoutes() as stream_routes:
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            mc.update(preds[lo:lo + batch], target[lo:lo + batch])
        results = {k: float(v) for k, v in mc.compute().items()}
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    groups = sorted(sorted(g) for g in mc.compute_groups.values())
    check(["wil", "wip"] in groups and ["wer"] in groups and ["mer"] in groups,
          f"librispeech compute groups {groups}: WIL and WIP together, WER and MER apart")
    updates = -(-n // batch)

    calls, whole = [], {}
    for name, fn, level in (("wer", "word_error_rate", "word"), ("cer", "char_error_rate", "char"),
                            ("mer", "match_error_rate", "word"), ("wil", "word_information_lost", "word"),
                            ("wip", "word_information_preserved", "word"), ("edit", "edit_distance", "char")):
        tok = str.split if level == "word" else list
        cells = sum(len(tok(p)) * len(tok(t)) for p, t in zip(preds, target))
        with DPRoutes() as routes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole[name] = float(getattr(F, fn)(preds, target))
            ms = (time.perf_counter() - t0) * 1e3
        calls.append({"fn": fn, "pairs": n, "cells": cells, "route": "device" if routes.calls else "host",
                      "device_dp_calls": len(routes.calls), "ms": ms})

    ref = {"words": [], "chars": []}
    for future in pending:
        part = future.result()
        ref["words"] += part["words"]
        ref["chars"] += part["chars"]
    w_err, c_err = sum(ref["words"]), sum(ref["chars"])
    n_ref_words = sum(len(t.split()) for t in target)
    n_pred_words = sum(len(p.split()) for p in preds)
    n_max = sum(max(len(p.split()), len(t.split())) for p, t in zip(preds, target))
    n_chars = sum(len(t) for t in target)
    states = {k: {s: float(v) for s, v in m.metric_state.items()} for k, m in mc.items()}
    want_states = {
        "wer": {"errors": w_err, "total": n_ref_words}, "cer": {"errors": c_err, "total": n_chars},
        "mer": {"errors": w_err, "total": n_max},
        "wil": {"errors": w_err - n_max, "target_total": n_ref_words, "preds_total": n_pred_words},
        "wip": {"errors": w_err - n_max, "target_total": n_ref_words, "preds_total": n_pred_words},
        "edit": {"edit_scores": c_err, "num_elements": n},
    }
    check(states == want_states, f"librispeech states {states} != plain-Python Levenshtein {want_states}")
    hits = n_max - w_err
    want = {"wer": w_err / n_ref_words, "cer": c_err / n_chars, "mer": w_err / n_max,
            "wil": 1 - (hits / n_ref_words) * (hits / n_pred_words), "wip": (hits / n_ref_words) * (hits / n_pred_words),
            "edit": c_err / n}
    errs = {k: max(abs(results[k] - v), abs(whole[k] - v)) / abs(v) for k, v in want.items()}
    check(max(errs.values()) <= TEXT_RATE_RTOL, f"librispeech rates vs float64: {errs}")
    limit = importlib.import_module("torchmetrics_tpu_torch.functional.text.helper")._HOST_DISPATCH_MAX_CELLS
    check(all(c["route"] == ("host" if c["cells"] <= limit else "device") for c in calls),
          f"whole-corpus calls not routed by their size: {calls}")
    out = {"phase": "librispeech_asr", "utterances": n, "reference_words": n_ref_words, "reference_chars": n_chars,
           "updates": updates, "results": results, "max_rel_err_vs_float64": max(errs.values()),
           "tolerance": {"counts": "exact", "rates": TEXT_RATE_RTOL}, "compute_groups": groups,
           "stream": {"seconds": stream_s, "utterances_per_s": n / stream_s,
                      "device_dp_calls": len(stream_routes.calls),
                      "host_dp_calls": 5 * updates + 1 - len(stream_routes.calls)},
           "whole_corpus": calls, "card": smi}
    emit(out)
    return out


def phase_cnndm_rouge(torch, np, dev, corpus, pending: dict, smi: str, batch: int = 64,
                      collection_pairs: int = 1000) -> dict:
    """BASELINE config 5 on CNN/DailyMail test's shape: ``ROUGEScore`` streamed, ``rouge_score`` over all pairs, then
    the config's ``MetricCollection`` of ``ROUGEScore`` and ``BERTScore()`` against each run alone."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.functional.text import rouge_score
    from torchmetrics_tpu_torch.functional.text.rouge import _normalize_and_tokenize_text
    from torchmetrics_tpu_torch.text import BERTScore, ROUGEScore

    helper = importlib.import_module("torchmetrics_tpu_torch.functional.text.helper")
    preds, target = corpus
    n = len(preds)
    keys = ("rouge1", "rouge2", "rougeL", "rougeLsum")
    metric = ROUGEScore(rouge_keys=keys, accumulate="best")
    torch.cuda.synchronize()
    with DPRoutes() as stream_routes:
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            metric.update(preds[lo:lo + batch], target[lo:lo + batch])
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = {k: float(v) for k, v in metric.compute().items()}
    compute_ms = (time.perf_counter() - t0) * 1e3
    with DPRoutes() as routes:
        t0 = time.perf_counter()
        whole = {k: float(v) for k, v in rouge_score(preds, target, rouge_keys=keys[:3]).items()}
        whole_ms = (time.perf_counter() - t0) * 1e3
    tokens = ([_normalize_and_tokenize_text(p) for p in preds], [_normalize_and_tokenize_text(t) for t in target])
    lcs = helper._lcs_tokens(*tokens, device=dev)

    ref = {"1": [], "2": [], "L": []}
    ref_lcs = []
    for future in pending["rouge"]:
        part = future.result()
        for key in ref:
            ref[key] += part["scores"][key]
        ref_lcs += part["lcs"]
    check(np.array_equal(lcs, np.asarray(ref_lcs, np.float32)), "cnndm LCS lengths != plain-Python LCS")
    errs = {}
    for key in ("1", "2", "L"):
        for i, stat in enumerate(("precision", "recall", "fmeasure")):
            want = float(np.mean([s[i] for s in ref[key]]))
            errs[f"rouge{key}_{stat}"] = max(abs(res[f"rouge{key}_{stat}"] - want), abs(whole[f"rouge{key}_{stat}"] - want))
    check(max(errs.values()) <= ROUGE_F64_ATOL, f"cnndm ROUGE vs float64: {errs}")
    cpu_lsum = np.asarray([x for future in pending["rouge_lsum"] for x in future.result()], np.float32)
    card_lsum = torch.cat(metric.rougeLsum_fmeasure).cpu().numpy()
    lsum_err = max(float(np.abs(card_lsum - cpu_lsum).max()), abs(res["rougeLsum_fmeasure"] - float(cpu_lsum.mean())))
    check(lsum_err <= ROUGE_F64_ATOL, f"cnndm rougeLsum vs the CPU run: {lsum_err}")
    check(routes.calls and routes.calls[0]["pairs"] == n, f"rouge_score over all pairs did not take the device route")

    # the config's collection on the first pairs, against each member alone
    head_p, head_t = preds[:collection_pairs], target[:collection_pairs]
    mc = MetricCollection({"rouge": ROUGEScore(rouge_keys=keys), "bertscore": BERTScore()})
    alone = {"rouge": ROUGEScore(rouge_keys=keys), "bertscore": BERTScore()}
    t0 = time.perf_counter()
    for lo in range(0, collection_pairs, batch):
        mc.update(head_p[lo:lo + batch], head_t[lo:lo + batch])
    together = mc.compute()
    torch.cuda.synchronize()
    collection_s = time.perf_counter() - t0
    for lo in range(0, collection_pairs, batch):
        for m in alone.values():
            m.update(head_p[lo:lo + batch], head_t[lo:lo + batch])
    single = {**alone["rouge"].compute(), **alone["bertscore"].compute()}
    check(sorted(together) == sorted(single), f"collection keys {sorted(together)}")
    check(all(torch.equal(together[k], single[k]) for k in single), "config 5 collection != its members alone")
    out = {"phase": "cnndm_rouge", "pairs": n, "updates": -(-n // batch), "results": res,
           "max_abs_err_vs_float64": max(errs.values()), "rougeLsum_max_abs_err_vs_cpu_run": lsum_err,
           "tolerance": {"rouge1/2/L vs float64": ROUGE_F64_ATOL, "lcs": "exact", "rougeLsum vs cpu": ROUGE_F64_ATOL},
           "stream": {"seconds": stream_s, "pairs_per_s": n / stream_s, "compute_ms": compute_ms,
                      "device_dp_calls": len(stream_routes.calls)},
           "whole_corpus": {"fn": "rouge_score", "keys": list(keys[:3]), "ms": whole_ms, "dp_calls": routes.calls},
           "config5_collection": {"pairs": collection_pairs, "seconds": collection_s,
                                  "pairs_per_s": collection_pairs / collection_s,
                                  "bertscore_f1": float(together["f1"].mean()), "check": "equal to each alone"},
           "card": smi}
    emit(out)
    return out


def phase_wmt_mt(torch, np, corpus, pending: list, smi: str, batch: int = 100) -> dict:
    """BLEU, SacreBLEU (13a, intl), chrF, chrF++, TER and EED over 2,999 WMT-shaped pairs in updates of ``batch``,
    each against the port's CPU run of the same updates."""
    preds, target = corpus
    n = len(preds)
    metrics = wmt_metrics(None)
    rates, card = {}, {}
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            metric.update(preds[lo:lo + batch], [[t] for t in target[lo:lo + batch]])
        card[name] = _mt_result(metric)
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t0)
    cpu = {}
    for future in pending:
        cpu.update(future.result())
    errs = {}
    for name, got in card.items():
        want = cpu[name]
        exact = {k: v for k, v in got["states"].items() if k not in ("sentence_eed", "sentence_ter")}
        check(exact == {k: want["states"][k] for k in exact}, f"wmt {name}: states differ from the CPU run")
        err = abs(got["score"] - want["score"]) / max(abs(want["score"]), 1e-30)
        if got["sentence"] is not None:
            err = max(err, float(np.max(np.abs(np.asarray(got["sentence"]) - np.asarray(want["sentence"])))))
        errs[name] = err
        check(err <= MT_RTOL, f"wmt {name} vs the CPU run: {err}")
    out = {"phase": "wmt_mt", "pairs": n, "updates": -(-n // batch),
           "scores": {k: v["score"] for k, v in card.items()}, "max_err_vs_cpu_run": errs,
           "tolerance": {"n-gram and TER counts": "exact", "scores": MT_RTOL}, "pairs_per_s": rates, "card": smi}
    emit(out)
    return out


def phase_perplexity_wikitext(torch, np, dev, gen, smi: str, updates: int = 36, batch: int = 8, seq: int = 1024) -> dict:
    """``Perplexity(ignore_index=-100)`` at GPT-2's vocabulary over WikiText-2 test's ~287,000 tokens, float32 and bf16
    logits, against a float64 log-softmax on the card."""
    from torchmetrics_tpu_torch.text import Perplexity

    metrics = {"float32": Perplexity(ignore_index=-100), "bfloat16": Perplexity(ignore_index=-100)}
    ref = {k: [0.0, 0] for k in metrics}
    seconds = {k: 0.0 for k in metrics}
    peak = {k: 0 for k in metrics}
    for _ in range(updates):
        logits = torch.randn((batch, seq, PPL_VOCAB), generator=gen, device=dev) * 2.0
        target = torch.randint(0, PPL_VOCAB, (batch, seq), generator=gen, device=dev)
        target[torch.rand((batch, seq), generator=gen, device=dev) < 0.01] = -100
        for name, metric in metrics.items():
            x = logits if name == "float32" else logits.to(torch.bfloat16)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metric.update(x, target)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated() - base)
            mask = target != -100
            lp = torch.log_softmax(x.double(), dim=-1).gather(-1, torch.where(mask, target, 0)[..., None])[..., 0]
            ref[name][0] -= float(lp[mask].sum())
            ref[name][1] += int(mask.sum())
            del x, lp
        del logits
    tokens = updates * batch * seq
    res, errs = {}, {}
    for name, metric in metrics.items():
        res[name] = float(metric.compute())
        want = float(np.exp(ref[name][0] / ref[name][1]))
        errs[name] = abs(res[name] - want) / want
        check(float(metric.count) == ref[name][1], f"perplexity {name}: count {float(metric.count)} != {ref[name][1]}")
        check(errs[name] <= PPL_F64_RTOL, f"perplexity {name} vs float64: {errs[name]}")
    out = {"phase": "perplexity_wikitext", "vocab": PPL_VOCAB, "updates": updates, "batch": [batch, seq],
           "tokens": tokens, "counted_tokens": ref["float32"][1], "perplexity": res, "rel_err_vs_float64": errs,
           "tolerance": PPL_F64_RTOL, "tokens_per_s": {k: tokens / s for k, s in seconds.items()},
           "update_peak_bytes_above_inputs": peak,
           "logits_bytes_an_update": {"float32": batch * seq * PPL_VOCAB * 4, "bfloat16": batch * seq * PPL_VOCAB * 2}, "card": smi}
    emit(out)
    return out


def phase_squad_v1(torch, corpus, pending, smi: str, batch: int = 1000) -> dict:
    """``SQuAD()`` over SQuAD v1.1 dev's 10,570 questions in updates of ``batch``: states and scores equal to the CPU run."""
    from torchmetrics_tpu_torch.text import SQuAD

    preds, target = corpus
    metric = SQuAD()
    t0 = time.perf_counter()
    for lo in range(0, len(preds), batch):
        metric.update(preds[lo:lo + batch], target[lo:lo + batch])
    result = {k: float(v) for k, v in metric.compute().items()}
    seconds = time.perf_counter() - t0
    cpu = pending.result()
    states = {k: float(v) for k, v in metric.metric_state.items()}
    check(states == cpu["states"] and result == cpu["result"], f"squad {states} {result} != CPU run {cpu}")
    out = {"phase": "squad_v1", "questions": len(preds), "result": result, "check": "states and scores equal to the CPU run",
           "questions_per_s": len(preds) / seconds, "card": smi}
    emit(out)
    return out


def phase_edit_dispatch(torch, dev, cases: dict, host_ms: dict, smi: str) -> dict:
    """The edit DP's two routes by batch and level: the host DP (timed in a worker) against the batched loop on the card
    (host clock, ending in a synchronize), the cells where they cost the same, and the route the dispatcher takes."""
    helper = importlib.import_module("torchmetrics_tpu_torch.functional.text.helper")
    limit = helper._HOST_DISPATCH_MAX_CELLS
    rows = []
    for key, (preds, target) in cases.items():
        cells = sum(len(p) * len(t) for p, t in zip(preds, target))
        helper._HOST_DISPATCH_MAX_CELLS = -1
        try:
            device_ms = wall_ms(torch, lambda: helper._edit_distance_tokens(preds, target, device=dev),
                                reps=10 if len(preds) <= 256 else 5, warmup=2)
        finally:
            helper._HOST_DISPATCH_MAX_CELLS = limit
        steps = max(len(p) for p in preds)
        faster = "host" if host_ms[key] < device_ms else "device"
        rows.append({"case": key, "pairs": len(preds), "cells": cells, "steps": steps, "host_ms": host_ms[key],
                     "device_ms": device_ms, "faster": faster, "break_even_cells": cells * device_ms / host_ms[key],
                     "dispatch": "host" if cells <= limit else "device"})
    agree = sum(r["faster"] == r["dispatch"] for r in rows)
    out = {"phase": "edit_dispatch", "threshold_cells": limit, "cases": rows, "dispatch_agrees": f"{agree}/{len(rows)}",
           "largest_host_faster_cells": max([r["cells"] for r in rows if r["faster"] == "host"], default=0),
           "smallest_device_faster_cells": min([r["cells"] for r in rows if r["faster"] == "device"], default=0),
           "device_ms": "wall time of one call, encode to read-back-ready, threshold forced to the device route",
           "card": smi}
    emit(out)
    return out


def text_family(torch, np, dev, gen, smi: str, counters: dict, make_corpora, t_main: float,
                dispatch_batches=(1, 4, 32, 256, 2620), perplexity_updates: int = 36) -> dict:
    """Phases 22-27 on the corpora ``make_corpora()`` draws, with their host references in worker processes; B1-B5's
    launch counters must stay at 0. ``t_main`` is when the script started: the last line gives the time since."""
    t0 = time.perf_counter()
    corpora = make_corpora()
    corpora_seconds = time.perf_counter() - t0
    for counter in counters.values():
        counter.launches.reset()
    cases = edit_dispatch_cases(corpora["asr"], dispatch_batches)
    with ProcessPoolExecutor(max_workers=6, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = submit_text_references(pool, corpora)
        host_dispatch = pool.submit(_host_edit_dispatch, cases)  # read last: it times the host DP alone in its worker
        phase_librispeech_asr(torch, np, corpora["asr"], pending["asr"], smi)
        phase_cnndm_rouge(torch, np, dev, corpora["cnndm"], pending, smi)
        phase_wmt_mt(torch, np, corpora["wmt"], pending["wmt"], smi)
        phase_perplexity_wikitext(torch, np, dev, gen, smi, updates=perplexity_updates)
        phase_squad_v1(torch, corpora["squad"], pending["squad"], smi)
        phase_edit_dispatch(torch, dev, cases, host_dispatch.result(), smi)
    launches = {name: int(counter.launches) for name, counter in counters.items()}
    check(not any(launches.values()), f"the text family launched a kernel of B1-B5: {launches}")
    out = {"phase": "text_family", "seconds": time.perf_counter() - t0, "corpora_seconds": corpora_seconds,
           "seconds_since_start": time.perf_counter() - t_main, "kernel_launches": launches}
    emit(out)
    return out


# ------------------------------------------- the rest of image (phases 28-32, data from --seed)
IS_RTOL = 1e-5  # IS against float64 numpy from the metric's own features, under the same permutation (of the mean)
KID_RTOL, KID_ATOL = 1e-4, 1e-6  # the unbiased MMD cancels sums of ~1e6 cubed kernel values down to ~1e-2
COSINE_RTOL = 1e-5  # MiFID's memorization term: a float32 mean of 10,000 minima of 1 - |cos|
MIFID_FID_RTOL = FID_RTOL  # MiFID's FID part: float32 eigensolvers against float64, as in fid_cifar10_10k
PPL_STAT_RTOL = 1e-6  # PPL's mean and std against float64 numpy from its own distances and quantiles
# the first 256 PPL distances on float32 maps, card against the port's CPU run, over the median |distance|:
# a pair's images differ by ~1e-4 of their size, so float32 rounding in the generator and the trunk (~1e-7 of a
# value, grown over ~20 layers) is ~1e-2 of the difference, and the distance squares it. The runs on an H100 gave
# median 5.3e-3, p90 1.3e-2, max 4.6e-2 on these inputs; a pair computed wrongly is off by ~1 of the median.
PPL_CPU_RTOL = {"median": 1e-2, "p90": 3e-2, "max": 1e-1}
DIV2K_PSNR_RTOL = 1e-6
DIV2K_RTOL = 1e-5  # SSIM, MS-SSIM, UQI, VIF against float64 windows: float32 E[x^2] - E[x]^2 on smooth images
WV3_RTOL = 1e-6  # the card against the port's CPU run of the same updates
WV3_INDEX_ATOL = 1e-6  # D_lambda, D_s: means of differences of UQIs, each within 1e-6 of its scale (|Q| <= 1)
REST_RTOL = 1e-6
WV3_BANDS = 8  # WorldView-3's multispectral bands
PPL_SEED_OFFSET = 28
DIV2K_HW = (1356, 2040)  # one DIV2K validation size (the set's widths are ~2040, heights vary)
LIVE1_HW = (512, 768)  # LIVE1's most common JPEG test size (H, W)


def _host_inception_score(np, features, splits: int, seed: int):
    """IS in float64 from ``features``, under the permutation numpy's global generator draws after ``seed``."""
    np.random.seed(seed)
    f = features[np.random.permutation(len(features))]
    f = f - f.max(axis=1, keepdims=True)
    log_prob = f - np.log(np.exp(f).sum(axis=1, keepdims=True))
    prob = np.exp(log_prob)
    size = len(f) // splits
    scores = []
    for k in range(splits):
        p, lp = prob[k * size:(k + 1) * size], log_prob[k * size:(k + 1) * size]
        mean_prob = p.mean(axis=0, keepdims=True)
        scores.append(np.exp((p * (lp - np.log(np.maximum(mean_prob, 1e-10)))).sum(axis=1).mean()))
    scores = np.asarray(scores)
    return float(scores.mean()), float(scores.std(ddof=1))


def _kid_float64(torch, np, real, fake, subsets: int, subset_size: int, seed: int):
    """KID's mean and std in float64 on the card, on the subsets numpy's global generator draws after ``seed``."""
    np.random.seed(seed)
    perms = [(np.random.permutation(len(real))[:subset_size], np.random.permutation(len(fake))[:subset_size])
             for _ in range(subsets)]
    real, fake = real.double(), fake.double()
    d, m = real.shape[1], subset_size
    kernel = lambda a, b: (a @ b.T / d + 1.0) ** 3  # noqa: E731
    scores = []
    for pr, pf in perms:
        x = real[torch.as_tensor(pr, device=real.device)]
        y = fake[torch.as_tensor(pf, device=fake.device)]
        kxx, kyy, kxy = kernel(x, x), kernel(y, y), kernel(x, y)
        within = kxx.sum() - kxx.diagonal().sum() + kyy.sum() - kyy.diagonal().sum()
        scores.append(within / (m * (m - 1)) - 2 * kxy.sum() / m**2)
    scores = torch.stack(scores).cpu().numpy()
    return float(scores.mean()), float(scores.std(ddof=1))


def _cosine_float64(torch, fake, real) -> float:
    """MiFID's mean over generated features of the least ``1 - |cos|`` to a real one, in float64, unthresholded."""
    f1 = fake.double() / fake.double().norm(dim=1, keepdim=True).clamp(min=1e-12)
    f2 = real.double() / real.double().norm(dim=1, keepdim=True).clamp(min=1e-12)
    return float((1.0 - (f1 @ f2.T).abs()).min(dim=1).values.mean())


def phase_generative_cifar10(torch, np, ce, dev, gen, npz: str, smi: str, seed: int, n_is: int = 50_000,
                             n_kid: int = 10_000, batch: int = 200, subsets: int = 100, subset_size: int = 1000) -> dict:
    """IS over ``n_is`` generated images, then KID and MiFID in one collection over ``n_kid`` real and generated ones."""
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.image import (InceptionScore, KernelInceptionDistance,
                                              MemorizationInformedFrechetInceptionDistance)
    from torchmetrics_tpu_torch.image.mifid import _compute_cosine_distance

    generated = torch.randint(0, 256, (n_is, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    real = torch.randint(0, 256, (n_kid, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    noise = torch.randint(-20, 21, real.shape, generator=gen, device=dev, dtype=torch.int16)
    fake = (real.to(torch.int16) + 24 + noise).clamp_(0, 255).to(torch.uint8)  # brighter, noisier copies
    launches0 = int(ce.matmul_bias_relu.launches), int(ce.bias_relu_.launches)

    inception_score = InceptionScore(weights_path=npz)  # logits_unbiased, splits=10, the bf16 fused trunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, n_is, batch):
        inception_score.update(generated[start:start + batch])
    torch.cuda.synchronize()
    is_stream_s = time.perf_counter() - t0
    np.random.seed(seed)
    t0 = time.perf_counter()
    is_mean, is_std = inception_score.compute()
    torch.cuda.synchronize()
    is_compute_ms = (time.perf_counter() - t0) * 1e3
    features = torch.cat(inception_score.features)
    check(tuple(features.shape) == (n_is, 1008), f"IS features {tuple(features.shape)}")
    host_mean, host_std = _host_inception_score(np, features.double().cpu().numpy(), 10, seed)
    # the std is held to the mean's scale: a float32 rounding of each split's score (~1e-7 of the mean) moves it so
    is_err = max(abs(float(is_mean) - host_mean), abs(float(is_std) - host_std)) / abs(host_mean)
    check(is_err <= IS_RTOL, f"IS ({float(is_mean)}, {float(is_std)}) vs float64 ({host_mean}, {host_std})")
    del inception_score, features

    collection = MetricCollection({
        "kid": KernelInceptionDistance(subsets=subsets, subset_size=subset_size, weights_path=npz),
        "mifid": MemorizationInformedFrechetInceptionDistance(cosine_distance_eps=0.1, weights_path=npz),
    })
    is_forwards = n_is // batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    updates = 0
    for start in range(0, n_kid, batch):
        collection.update(real[start:start + batch], real=True)
        collection.update(fake[start:start + batch], real=False)
        updates += 2
    torch.cuda.synchronize()
    kid_stream_s = time.perf_counter() - t0
    groups = sorted(sorted(g) for g in collection.compute_groups.values())
    check(groups == [["kid", "mifid"]], f"KID and MiFID compute groups {groups}")
    forwards = updates + 1  # a collection's first update runs every member to find the groups
    b2a = int(ce.matmul_bias_relu.launches) - launches0[0]
    b2b = int(ce.bias_relu_.launches) - launches0[1]
    check(b2a == 40 * (is_forwards + forwards) and b2b == 54 * (is_forwards + forwards),
          f"B2a/B2b launches {b2a}/{b2b} for {is_forwards} + {forwards} forwards")

    np.random.seed(seed + 1)
    t0 = time.perf_counter()
    kid_mean, kid_std = collection["kid"].compute()
    torch.cuda.synchronize()
    kid_compute_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mifid = collection["mifid"].compute()
    torch.cuda.synchronize()
    mifid_compute_ms = (time.perf_counter() - t0) * 1e3
    real_f, fake_f = torch.cat(collection["kid"].real_features), torch.cat(collection["kid"].fake_features)
    ref_kid = _kid_float64(torch, np, real_f, fake_f, subsets, subset_size, seed + 1)
    kid_err = [abs(float(got) - want) for got, want in zip((kid_mean, kid_std), ref_kid)]
    check(all(err <= max(KID_RTOL * abs(want), KID_ATOL) for err, want in zip(kid_err, ref_kid)),
          f"KID ({float(kid_mean)}, {float(kid_std)}) vs float64 {ref_kid}")

    cosine = float(_compute_cosine_distance(fake_f, real_f, 1.0))  # the unthresholded mean minimum
    cosine64 = _cosine_float64(torch, fake_f, real_f)
    cosine_err = abs(cosine - cosine64) / abs(cosine64)
    check(cosine_err <= COSINE_RTOL, f"MiFID cosine term {cosine} vs float64 {cosine64}")
    penalty = cosine if cosine < 0.1 else 1.0
    states = {}
    for prefix, f in (("real", real_f), ("fake", fake_f)):
        f64 = f.double()
        states[f"{prefix}_features_sum"] = f64.sum(dim=0).cpu().numpy()
        states[f"{prefix}_features_cov_sum"] = (f64.T @ f64).cpu().numpy()
        states[f"{prefix}_features_num_samples"] = float(len(f))
    fid64 = host_fid(np, states)["fid"]
    fid_part = float(mifid) * (penalty + 1e-15)
    fid_err = abs(fid_part - fid64) / abs(fid64)
    check(fid_err <= MIFID_FID_RTOL, f"MiFID's FID part {fid_part} vs float64 host {fid64}")
    result = {
        "phase": "generative_cifar10", "card": smi,
        "inception_score": {"images": n_is, "batch": batch, "splits": 10, "mean": float(is_mean), "std": float(is_std),
                            "err_vs_float64_of_mean": is_err, "images_per_s": n_is / is_stream_s,
                            "compute_ms": is_compute_ms},
        "kid_mifid": {"real": n_kid, "generated": n_kid, "updates": updates, "trunk_forwards": forwards,
                      "groups": groups, "kid": [float(kid_mean), float(kid_std)], "kid_float64": list(ref_kid),
                      "kid_abs_err": kid_err, "mifid": float(mifid), "cosine_term": cosine,
                      "cosine_rel_err": cosine_err, "fid_part": fid_part, "fid_float64": fid64,
                      "fid_part_rel_err": fid_err, "images_per_s": 2 * n_kid / kid_stream_s,
                      "kid_compute_ms": kid_compute_ms, "mifid_compute_ms": mifid_compute_ms},
        "launches": {"conv_mm_bias_relu": b2a, "bias_relu": b2b, "trunk_forwards": is_forwards + forwards},
    }
    emit(result)
    return result


def ppl_generator(torch, device, seed: int, latent: int = 512, side: int = 256):
    """A seeded StyleGAN-sized generator, no published one being at hand: a 512-wide latent, a linear layer to 256x4x4,
    six nearest-upsampling 3x3 conv blocks to 8x256x256 and a 1x1 conv with tanh to 3x256x256.

    The weights and the latents of ``sample(n)`` come from CPU generators seeded with ``seed``, so a run on any
    device draws the same ones. The convolutions run in full float32 (no TF32): PPL divides by epsilon squared.
    """
    from torchmetrics_tpu_torch.utilities.compute import full_fp32

    nn, F = torch.nn, torch.nn.functional
    widths = (256, 128, 64, 32, 16, 16, 8)
    steps = {4 * 2**i: i for i in range(7)}
    if side not in steps:
        raise ValueError(f"side {side} is not 4 times a power of two up to 256")

    class Generator(nn.Module):
        def __init__(self):
            super().__init__()
            self.latent = latent
            self.fc = nn.Linear(latent, widths[0] * 16)
            self.blocks = nn.ModuleList(nn.Conv2d(widths[i], widths[i + 1], 3, padding=1) for i in range(steps[side]))
            self.to_rgb = nn.Conv2d(widths[steps[side]], 3, 1)
            weights = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in self.parameters():
                    fan_in = p[0].numel() if p.ndim > 1 else 1
                    p.copy_(torch.randn(p.shape, generator=weights) * (2.0 / fan_in) ** 0.5 if p.ndim > 1
                            else torch.zeros(p.shape))
            self.latents = torch.Generator().manual_seed(seed + 1)
            self.to(device)

        def sample(self, n: int):
            return torch.randn((n, self.latent), generator=self.latents).to(device)

        def forward(self, z):
            with torch.no_grad(), full_fp32():
                h = F.leaky_relu(self.fc(z).view(-1, widths[0], 4, 4), 0.2)
                for block in self.blocks:
                    h = F.leaky_relu(block(F.interpolate(h, scale_factor=2, mode="nearest")), 0.2)
                return torch.tanh(self.to_rgb(h))

    return Generator()


def _cpu_ppl_distances(seed: int, n: int, threads: int = 2):
    """The first ``n`` PPL distances of the port's CPU run on float32 maps of the LPIPS-VGG weights, with the same
    generator and latents."""
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor
    from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length

    cpu = torch.device("cpu")
    sim_net = LPIPSExtractor(net_type="vgg", compute_dtype=torch.float32, device=cpu)
    return perceptual_path_length(ppl_generator(torch, cpu, seed), num_samples=n, batch_size=128,
                                  sim_net=sim_net, device=cpu)[2].numpy()


def phase_ppl_lpips_vgg(torch, np, lh, dev, seed: int, pending_cpu, smi: str, n_cpu: int = 256) -> dict:
    """``PerceptualPathLength()`` at its defaults (10,000 samples, batches of 128, lerp, epsilon 1e-4, resize 64,
    discards 0.01/0.99, LPIPS-VGG on bf16 maps) on the seeded generator; its first distances again on float32 maps.

    The CPU run is held to the float32 maps: PPL divides by epsilon squared, and a pair's maps differ by ~1e-4 of
    their size, below a bf16 ulp, so on bf16 maps the distances are the maps' rounding, which the two devices do
    in other places. The timed bf16 result is checked only against float64 statistics of its own distances."""
    from torchmetrics_tpu_torch.image import PerceptualPathLength
    from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor
    from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length
    from torchmetrics_tpu_torch.utilities.compute import full_fp32

    metric = PerceptualPathLength()
    generator = ppl_generator(torch, dev, seed)
    metric.update(generator)
    b3_before = int(lh.lpips_head.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, std, dists = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = int(lh.lpips_head.launches) - b3_before
    calls = -(-metric.num_samples // metric.batch_size)
    check(launches == 5 * calls, f"B3 launches {launches} for {calls} LPIPS-VGG calls")
    d64 = dists.double().cpu().numpy()
    check(d64.shape == (metric.num_samples,) and bool(np.isfinite(d64).all()), "PPL distances not finite")
    lower, upper = np.quantile(d64, 0.01), np.quantile(d64, 0.99)
    kept = d64[(d64 >= lower) & (d64 <= upper)]
    ref_mean, ref_std = kept.mean(), kept.std(ddof=1)
    stat_err = max(abs(float(mean) - ref_mean) / abs(ref_mean), abs(float(std) - ref_std) / abs(ref_std))
    check(stat_err <= PPL_STAT_RTOL, f"PPL ({float(mean)}, {float(std)}) vs float64 ({ref_mean}, {ref_std})")

    # the same first latents through float32 maps of the same weights (TF32 off), then the CPU run of both
    f32 = LPIPSExtractor(net_type="vgg", compute_dtype=torch.float32)
    with full_fp32():
        d32 = perceptual_path_length(ppl_generator(torch, dev, seed), num_samples=n_cpu, batch_size=128,
                                     sim_net=f32, device=dev)[2].double().cpu().numpy()
    side_launches = int(lh.lpips_head.launches) - b3_before - launches
    cpu = pending_cpu.result().astype(np.float64)
    # differences over the median |distance| (the random heads' weights make some distances cross zero)
    err32 = np.abs(d32 - cpu) / np.median(np.abs(cpu))
    err = {"median": float(np.median(err32)), "p90": float(np.quantile(err32, 0.9)), "max": float(err32.max())}
    result = {
        "phase": "ppl_lpips_vgg", "card": smi, "samples": metric.num_samples, "batch": metric.batch_size,
        "ppl_mean_bf16_maps": float(mean), "ppl_std_bf16_maps": float(std), "stat_rel_err": stat_err,
        "b3_launches": launches, "b3_launches_float32_maps": side_launches, "seconds": seconds,
        "samples_per_s": metric.num_samples / seconds, "first_256_float32_maps_vs_cpu": err,
        "tolerance": {"stat": PPL_STAT_RTOL, "float32_maps_vs_cpu": PPL_CPU_RTOL},
        "reference": "bf16 maps: float64 statistics of their own distances only (the distances are the maps' "
                     "rounding at epsilon 1e-4); float32 maps: the port's CPU run",
        "median_abs_distance": {"bf16_maps": float(np.median(np.abs(d64[:n_cpu]))),
                                "float32_maps": float(np.median(np.abs(d32)))},
        "distance_quantiles": [float(q) for q in np.quantile(d64, [0.01, 0.5, 0.99])],
    }
    emit(result)
    for stat, limit in PPL_CPU_RTOL.items():
        check(err[stat] <= limit, f"PPL's first {n_cpu} distances on float32 maps vs the CPU run: {stat} {err[stat]}")
    return result


def div2k_pairs(torch, dev, gen, n: int, hw=DIV2K_HW, chunk: int = 10):
    """Seeded smooth targets with texture in [0, 1], and their x4 bicubic down- and up-scaling plus noise."""
    F = torch.nn.functional
    targets, preds = [], []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        base = F.interpolate(torch.rand((m, 3, hw[0] // 32, hw[1] // 32), generator=gen, device=dev), size=hw,
                             mode="bicubic", align_corners=False)
        texture = F.interpolate(torch.rand((m, 3, hw[0] // 4, hw[1] // 4), generator=gen, device=dev) - 0.5, size=hw,
                                mode="bilinear", align_corners=False)
        target = (0.8 * base + 0.3 * texture + 0.1).clamp_(0.0, 1.0)
        low = F.interpolate(target, scale_factor=0.25, mode="bicubic", align_corners=False, antialias=True)
        pred = F.interpolate(low, size=hw, mode="bicubic", align_corners=False)
        pred.add_(0.01 * torch.randn(pred.shape, generator=gen, device=dev)).clamp_(0.0, 1.0)
        targets.append(target)
        preds.append(pred)
    return torch.cat(preds), torch.cat(targets)


def _window64(torch, size: int, sigma: float, dev):
    x = torch.arange(size, dtype=torch.float64, device=dev) - (size - 1) / 2
    g = torch.exp(-((x / sigma) ** 2) / 2)
    return g / g.sum()


def _conv64(torch, x, g):
    """Valid float64 convolution of every channel with the window ``outer(g, g)``, as its two 1-D passes."""
    F = torch.nn.functional
    c, k = x.shape[1], g.numel()
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim64(torch, p, t, data_range: float = 1.0):
    """Per-image float64 SSIM and contrast sensitivity: gaussian 11x11 window (sigma 1.5), reflect pad 5, cropped means."""
    F = torch.nn.functional
    g = _window64(torch, 11, 1.5, p.device)
    p, t = F.pad(p, (5, 5, 5, 5), mode="reflect"), F.pad(t, (5, 5, 5, 5), mode="reflect")
    mu_x, mu_y = _conv64(torch, p, g), _conv64(torch, t, g)
    s_x = (_conv64(torch, p * p, g) - mu_x**2).clamp(min=0.0)
    s_y = (_conv64(torch, t * t, g) - mu_y**2).clamp(min=0.0)
    s_xy = _conv64(torch, p * t, g) - mu_x * mu_y
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cs = (2 * s_xy + c2) / (s_x + s_y + c2)
    ssim = (2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1) * cs
    crop = (Ellipsis, slice(5, -5), slice(5, -5))
    return ssim[crop].flatten(1).mean(dim=1), cs[crop].flatten(1).mean(dim=1)


def _ms_ssim64(torch, p, t, betas=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
    F = torch.nn.functional
    values = []
    for i in range(len(betas)):
        sim, cs = _ssim64(torch, p, t)
        values.append(cs)
        if i < len(betas) - 1:
            p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)
    values[-1] = sim
    stack = torch.stack(values).clamp(min=0.0)
    return torch.prod(stack ** torch.tensor(betas, dtype=torch.float64, device=p.device)[:, None], dim=0)


def _uqi64(torch, p, t):
    F = torch.nn.functional
    g = _window64(torch, 11, 1.5, p.device)
    p, t = F.pad(p, (5, 5, 5, 5), mode="reflect"), F.pad(t, (5, 5, 5, 5), mode="reflect")
    mu_x, mu_y = _conv64(torch, p, g), _conv64(torch, t, g)
    s_x = _conv64(torch, p * p, g) - mu_x**2
    s_y = _conv64(torch, t * t, g) - mu_y**2
    s_xy = _conv64(torch, p * t, g) - mu_x * mu_y
    eps = float(torch.finfo(torch.float32).eps)
    uqi = (2 * mu_x * mu_y * 2 * s_xy) / ((mu_x**2 + mu_y**2) * (s_x + s_y) + eps)
    return uqi[..., 5:-5, 5:-5].flatten(1).mean(dim=1)


def _vif64(torch, p, t, sigma_n_sq: float = 2.0):
    """Per-(image, channel) float64 VIF-p: four scales, the reference's masks."""
    eps = 1e-10
    num = torch.zeros(p.shape[:2], dtype=torch.float64, device=p.device)
    den = torch.zeros_like(num)
    for scale in range(4):
        n = int(2 ** (4 - scale) + 1)
        g = _window64(torch, n, n / 5, p.device)
        if scale > 0:
            t, p = _conv64(torch, t, g)[:, :, ::2, ::2], _conv64(torch, p, g)[:, :, ::2, ::2]
        mu_t, mu_p = _conv64(torch, t, g), _conv64(torch, p, g)
        s_t = (_conv64(torch, t * t, g) - mu_t**2).clamp(min=0.0)
        s_p = (_conv64(torch, p * p, g) - mu_p**2).clamp(min=0.0)
        s_tp = _conv64(torch, t * p, g) - mu_t * mu_p
        gain = s_tp / (s_t + eps)
        s_v = s_p - gain * s_tp
        m1 = s_t < eps
        gain, s_v, s_t = gain.masked_fill(m1, 0.0), torch.where(m1, s_p, s_v), s_t.masked_fill(m1, 0.0)
        m2 = s_p < eps
        gain, s_v = gain.masked_fill(m2, 0.0), s_v.masked_fill(m2, 0.0)
        m3 = gain < 0
        s_v, gain = torch.where(m3, s_p, s_v), gain.masked_fill(m3, 0.0)
        s_v = s_v.clamp(min=eps)
        num += torch.log10(1.0 + gain**2 * s_t / (s_v + sigma_n_sq)).sum(dim=(2, 3))
        den += torch.log10(1.0 + s_t / sigma_n_sq).sum(dim=(2, 3))
    return (num / den).flatten()


def div2k_collection():
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.image import (MultiScaleStructuralSimilarityIndexMeasure, PeakSignalNoiseRatio,
                                              StructuralSimilarityIndexMeasure, UniversalImageQualityIndex,
                                              VisualInformationFidelity)

    return MetricCollection({
        "psnr": PeakSignalNoiseRatio(data_range=1.0),
        "ssim": StructuralSimilarityIndexMeasure(data_range=1.0),
        "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0),
        "uqi": UniversalImageQualityIndex(),
        "vif": VisualInformationFidelity(),
    })


def phase_div2k_sr(torch, np, dev, gen, smi: str, n: int = 100, batch: int = 4, hw=DIV2K_HW) -> dict:
    """DIV2K validation's x4 super-resolution scores: PSNR, SSIM, MS-SSIM, UQI and VIF in one collection."""
    preds, target = div2k_pairs(torch, dev, gen, n, hw)
    collection = div2k_collection()
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        collection.update(preds[lo:lo + batch], target[lo:lo + batch])
    values = collection.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
    groups = sorted(sorted(g) for g in collection.compute_groups.values())
    check(["ssim"] in groups and ["ms_ssim"] in groups, f"SSIM and MS-SSIM share a compute group: {groups}")

    sse, ref = 0.0, {"ssim": [], "ms_ssim": [], "uqi": [], "vif": []}
    for lo in range(0, n, batch):
        p, t = preds[lo:lo + batch].double(), target[lo:lo + batch].double()
        sse += float(((p - t) ** 2).sum())
        ref["ssim"].append(_ssim64(torch, p, t)[0])
        ref["ms_ssim"].append(_ms_ssim64(torch, p, t))
        ref["uqi"].append(_uqi64(torch, p, t))
        ref["vif"].append(_vif64(torch, p, t))
    want = {"psnr": float(10.0 * np.log10(1.0 / (sse / preds.numel())))}
    want.update({k: float(torch.cat(v).mean()) for k, v in ref.items()})
    errors = {k: abs(float(values[k]) - want[k]) / abs(want[k]) for k in want}
    check(errors["psnr"] <= DIV2K_PSNR_RTOL, f"PSNR {float(values['psnr'])} vs float64 {want['psnr']}")
    for key in ("ssim", "ms_ssim", "uqi", "vif"):
        check(errors[key] <= DIV2K_RTOL, f"{key} {float(values[key])} vs float64 {want[key]}")
    timing = div2k_collection()
    update_ms = wall_ms(torch, lambda: timing.update(preds[:batch], target[:batch]), reps=5, warmup=1)
    result = {
        "phase": "div2k_sr", "card": smi, "pairs": n, "hw": list(hw), "batch": batch,
        "values": {k: float(v) for k, v in values.items()}, "float64": want, "rel_err": errors, "groups": groups,
        "seconds": seconds, "pairs_per_s": n / seconds, "update_ms": update_ms, "peak_above_inputs_bytes": peak_above,
    }
    emit(result)
    return result


def _blocky_live1(torch, gen, dev, n: int, hw=LIVE1_HW):
    """Y-channel images in [0, 255] and predictions with an offset on every 8x8 block, plus noise."""
    F = torch.nn.functional
    base = F.interpolate(torch.rand((n, 1, hw[0] // 16, hw[1] // 16), generator=gen, device=dev), size=hw,
                         mode="bicubic", align_corners=False)
    target = (255.0 * (0.8 * base + 0.1)).clamp_(0.0, 255.0).round_()
    offsets = 4.0 * torch.randn((n, 1, hw[0] // 8, hw[1] // 8), generator=gen, device=dev)
    preds = target + offsets.repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
    preds += torch.randn(preds.shape, generator=gen, device=dev)
    return preds.clamp_(0.0, 255.0), target


def _host_psnrb(np, preds, target, block: int = 8) -> float:
    """PSNR-B in float64 over one-image updates: the summed squared error, the summed blocking factors, the widest range."""
    sse = total = bef = data_range = 0.0
    for p, t in zip(preds, target):
        p, t = p[0], t[0]
        sse += float(((p - t) ** 2).sum())
        total += p.size
        h, w = p.shape
        cols, rows = np.arange(w - 1), np.arange(h - 1)
        hb, hbc = cols[(cols + 1) % block == 0], cols[(cols + 1) % block != 0]
        vb, vbc = rows[(rows + 1) % block == 0], rows[(rows + 1) % block != 0]
        d_b = ((p[:, hb] - p[:, hb + 1]) ** 2).sum() + ((p[vb, :] - p[vb + 1, :]) ** 2).sum()
        d_bc = ((p[:, hbc] - p[:, hbc + 1]) ** 2).sum() + ((p[vbc, :] - p[vbc + 1, :]) ** 2).sum()
        n_hb = h * (w / block) - 1
        n_vb = w * (h / block) - 1
        d_b /= n_hb + n_vb
        d_bc /= (h * (w - 1) - n_hb) + (w * (h - 1) - n_vb)
        t_factor = np.log2(block) / np.log2(min(h, w))
        bef += t_factor * (d_b - d_bc) if d_b > d_bc else 0.0
        data_range = max(data_range, float(t.max() - t.min()))
    num = data_range**2 if data_range > 2 else 1.0
    return float(10.0 * np.log10(num / (sse / total + bef)))


def phase_image_quality_rest(torch, np, dev, gen, smi: str, n_tv: int = 16, side: int = 512, n_live1: int = 29) -> dict:
    """Total variation and image gradients on 16 3x512x512 images; PSNR-B at LIVE1's size, one image an update."""
    from torchmetrics_tpu_torch.functional.image import image_gradients, total_variation
    from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect

    img = torch.rand((n_tv, 3, side, side), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tv = total_variation(img)
    dy, dx = image_gradients(img)
    torch.cuda.synchronize()
    tv_grad_ms = (time.perf_counter() - t0) * 1e3
    host = img.double().cpu().numpy()
    want_dy = np.pad(np.diff(host, axis=2), ((0, 0), (0, 0), (0, 1), (0, 0)))
    want_dx = np.pad(np.diff(host, axis=3), ((0, 0), (0, 0), (0, 0), (0, 1)))
    want_tv = float(np.abs(np.diff(host, axis=2)).sum() + np.abs(np.diff(host, axis=3)).sum())
    tv_err = abs(float(tv) - want_tv) / want_tv
    grad_err = max(float(np.abs(dy.double().cpu().numpy() - want_dy).max()),
                   float(np.abs(dx.double().cpu().numpy() - want_dx).max()))
    check(tv_err <= REST_RTOL, f"total variation {float(tv)} vs float64 {want_tv}")
    check(grad_err <= REST_RTOL, f"image gradients max abs err {grad_err}")

    preds, target = _blocky_live1(torch, gen, dev, n_live1)
    metric = PeakSignalNoiseRatioWithBlockedEffect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_live1):
        metric.update(preds[i:i + 1], target[i:i + 1])
    psnrb = metric.compute()
    torch.cuda.synchronize()
    psnrb_s = time.perf_counter() - t0
    want_psnrb = _host_psnrb(np, preds.double().cpu().numpy(), target.double().cpu().numpy())
    psnrb_err = abs(float(psnrb) - want_psnrb) / abs(want_psnrb)
    check(float(metric.bef) > 0, "the blocking factor is zero: the blocks are not in play")
    check(psnrb_err <= REST_RTOL, f"PSNR-B {float(psnrb)} vs float64 {want_psnrb}")
    result = {
        "phase": "image_quality_rest", "card": smi,
        "total_variation": {"images": n_tv, "side": side, "value": float(tv), "rel_err": tv_err,
                            "gradients_max_abs_err": grad_err, "tv_and_gradients_ms": tv_grad_ms},
        "psnrb_live1": {"images": n_live1, "hw": list(LIVE1_HW), "psnrb": float(psnrb), "float64": want_psnrb,
                        "rel_err": psnrb_err, "bef_sum": float(metric.bef), "images_per_s": n_live1 / psnrb_s},
    }
    emit(result)
    return result


def wv3_data(torch, seed: int, n: int = 20, bands: int = WV3_BANDS, side_rr: int = 256, side_fr: int = 512,
             ratio: int = 4) -> dict:
    """PanCollection WorldView-3-shaped test sets on the CPU from ``seed``: the same tensors in every process.

    Reduced resolution: fused images against their ground truth, ``(n, 8, 256, 256)``. Full resolution: fused
    ``(n, 8, 512, 512)``, MS ``(n, 8, 128, 128)``, its x4 bicubic upsampling (EXP) and PAN replicated to 8 bands.
    """
    F = torch.nn.functional
    g = torch.Generator().manual_seed(seed)

    def scene(m, side):
        base = F.interpolate(torch.rand((m, 1, side // 16, side // 16), generator=g), size=(side, side),
                             mode="bicubic", align_corners=False)
        spectra = 0.5 + 0.5 * torch.rand((m, bands, 1, 1), generator=g)
        texture = F.interpolate(torch.rand((m, bands, side // 4, side // 4), generator=g) - 0.5, size=(side, side),
                                mode="bilinear", align_corners=False)
        return (0.7 * base * spectra + 0.2 * texture + 0.1).clamp_(0.0, 1.0)

    gt = scene(n, side_rr)
    gain = 1.0 + 0.05 * torch.randn((n, bands, 1, 1), generator=g)
    fused_rr = (gt * gain + 0.02 * torch.randn(gt.shape, generator=g)).clamp_(0.0, 1.0)
    hr = scene(n, side_fr)
    ms = F.avg_pool2d(hr, ratio)
    exp = F.interpolate(ms, scale_factor=ratio, mode="bicubic", align_corners=False).clamp_(0.0, 1.0)
    pan = (hr.mean(dim=1, keepdim=True) + 0.01 * torch.randn((n, 1, side_fr, side_fr), generator=g)).clamp_(0.0, 1.0)
    detail = pan - F.interpolate(F.avg_pool2d(pan, ratio), scale_factor=ratio, mode="bicubic", align_corners=False)
    fused_fr = (exp * gain + detail + 0.01 * torch.randn(exp.shape, generator=g)).clamp_(0.0, 1.0)
    return {"fused_rr": fused_rr, "gt": gt, "fused_fr": fused_fr, "ms": ms, "exp": exp,
            "pan": pan.expand(-1, bands, -1, -1).contiguous()}


WV3_GROUPS = {"reduced": ("ergas", "sam", "scc", "rase", "rmse_sw", "uqi"), "d_lambda": ("d_lambda",),
              "d_s": ("d_s",), "qnr": ("qnr",)}


def wv3_metric(name: str, device):
    from torchmetrics_tpu_torch import image as I

    make = {
        "ergas": lambda: I.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device=device),
        "sam": lambda: I.SpectralAngleMapper(device=device),
        "scc": lambda: I.SpatialCorrelationCoefficient(device=device),
        "rase": lambda: I.RelativeAverageSpectralError(window_size=8, device=device),
        "rmse_sw": lambda: I.RootMeanSquaredErrorUsingSlidingWindow(device=device),
        "uqi": lambda: I.UniversalImageQualityIndex(device=device),
        "d_lambda": lambda: I.SpectralDistortionIndex(device=device),
        "d_s": lambda: I.SpatialDistortionIndex(device=device),
        "qnr": lambda: I.QualityWithNoReference(device=device),
    }
    return make[name]()


def wv3_stream(torch, names, data: dict, device, batch: int = 5) -> dict:
    """Each metric of ``names`` over ``data`` in updates of ``batch`` images; ``{name: (value, compute ms)}``."""
    out = {}
    for name in names:
        metric = wv3_metric(name, device)
        for lo in range(0, len(data["gt"]), batch):
            cut = lambda key: data[key][lo:lo + batch].to(device)  # noqa: E731
            if name in WV3_GROUPS["reduced"]:
                metric.update(cut("fused_rr"), cut("gt"))
            elif name == "d_lambda":
                metric.update(cut("fused_fr"), cut("exp"))
            else:
                metric.update(cut("fused_fr"), {"ms": cut("ms"), "pan": cut("pan")})
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = float(metric.compute())
        out[name] = (value, (time.perf_counter() - t0) * 1e3)
    return out


def _cpu_wv3(seed: int, names, threads: int = 2) -> dict:
    """The port's CPU run of the same updates, in a worker process."""
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return {k: v[0] for k, v in wv3_stream(torch, names, wv3_data(torch, seed), torch.device("cpu")).items()}


def phase_pansharpening_wv3(torch, np, dev, seed: int, pending: list, smi: str) -> dict:
    data = wv3_data(torch, seed)
    got = wv3_stream(torch, [n for names in WV3_GROUPS.values() for n in names], data, dev)
    want = {}
    for future in pending:
        want.update(future.result())
    errors = {}
    for name, (value, _) in got.items():
        err = abs(value - want[name])
        errors[name] = err / abs(want[name])
        limit = WV3_INDEX_ATOL if name in ("d_lambda", "d_s") else WV3_RTOL * abs(want[name])
        check(err <= limit, f"{name} on the card {value} vs the CPU run {want[name]}")
    result = {
        "phase": "pansharpening_wv3", "card": smi, "reduced_resolution": [20, WV3_BANDS, 256, 256],
        "full_resolution": {"fused": [20, WV3_BANDS, 512, 512], "ms": [20, WV3_BANDS, 128, 128]},
        "values": {k: v[0] for k, v in got.items()}, "cpu": want, "rel_err_vs_cpu": errors,
        "compute_ms": {k: v[1] for k, v in got.items()},
    }
    emit(result)
    return result


def image_rest(torch, np, ce, lh, dev, gen, seed: int, smi: str, counters: dict, t_main: float) -> dict:
    """Phases 28-32 with their CPU references in worker processes; B1, B4 and B5 must not launch, B2a/B2b (the
    InceptionV3 trunk) and B3 (LPIPS-VGG) launch as the phases count them."""
    t0 = time.perf_counter()
    for counter in counters.values():
        counter.launches.reset()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        wv3 = [pool.submit(_cpu_wv3, seed, names) for names in WV3_GROUPS.values()]
        ppl_cpu = pool.submit(_cpu_ppl_distances, seed + PPL_SEED_OFFSET, 256)
        with tempfile.TemporaryDirectory() as folder:
            generative = phase_generative_cifar10(torch, np, ce, dev, gen, inception_npz(torch, np, seed, folder, dev, gen),
                                                  smi, seed)
        ppl = phase_ppl_lpips_vgg(torch, np, lh, dev, seed + PPL_SEED_OFFSET, ppl_cpu, smi)
        phase_div2k_sr(torch, np, dev, gen, smi)
        phase_image_quality_rest(torch, np, dev, gen, smi)
        phase_pansharpening_wv3(torch, np, dev, seed, wv3, smi)
    launches = {name: int(counter.launches) for name, counter in counters.items()}
    expected = {name: 0 for name in counters}
    expected.update(matmul_bias_relu=generative["launches"]["conv_mm_bias_relu"],
                    bias_relu_=generative["launches"]["bias_relu"],
                    lpips_head=ppl["b3_launches"] + ppl["b3_launches_float32_maps"])
    check(launches == expected, f"the rest of image launched {launches}, expected {expected}")
    launches["lpips_head"] = ppl["b3_launches"]  # the main path's: the metric's own calls
    out = {"phase": "image_rest", "seconds": time.perf_counter() - t0,
           "seconds_since_start": time.perf_counter() - t_main, "kernel_launches": launches}
    emit(out)
    return out


# ------------------------------------------- regression, pairwise and retrieval (phases 33-38)
NYU_MAPS, NYU_HW, NYU_BATCH = 654, (480, 640), 8  # NYU Depth v2's Eigen test split, updates of 8 maps
NYU_RTOL = 1e-5  # float32 sums of 2.46M pixels an update, 82 updates, against float64 sums of the same values
STS_RTOL = 1e-5  # Pearson, concordance, Spearman: float32 co-moments and rank means over 1,500-4,927 pairs
KENDALL_ATOL = 1e-6  # tau from exact int64 pair counts, one float32 formula, against scipy's float64
TWEEDIE_RTOL = 1e-5  # float32 deviance sums of 8,192 policies an update, 83 updates, against float64
CSI_RTOL = 1e-6  # one float32 division of exact int64 counts
PAIRWISE_RTOL = 1e-5  # of the largest |value| of the checked rows: float32 products and sums of 768 terms
KL_RTOL = 1e-5  # float32 row sums of 1,000 terms, a mean over 50,000 rows, against float64 of the same inputs
RETRIEVAL_ATOL = 1e-6  # a float32 mean of 6,980 per-query float32 values against float64 per-query loops
MSMARCO_QUERIES, MSMARCO_DEPTH, MSMARCO_BATCH = 6980, 1000, 100


def _rel(got, want: float) -> float:
    return abs(float(got) - want) / max(abs(want), 1e-30)


def nyu_collection():
    import torchmetrics_tpu_torch.regression as R
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "mse": R.MeanSquaredError(), "rmse": R.MeanSquaredError(squared=False), "mae": R.MeanAbsoluteError(),
        "msle": R.MeanSquaredLogError(), "mape": R.MeanAbsolutePercentageError(), "log_cosh": R.LogCoshError(),
        "r2": R.R2Score(), "explained_variance": R.ExplainedVariance(), "rse": R.RelativeSquaredError(),
        "minkowski3": R.MinkowskiDistance(p=3), "pearson": R.PearsonCorrCoef(),
    })


def _nyu_float64(torch, preds, target, batch: int) -> dict:
    """The eleven values from float64 sums of the same pixels."""
    sums = collections.Counter()
    for lo in range(0, preds.shape[0], batch):
        p, t = preds[lo:lo + batch].double().reshape(-1), target[lo:lo + batch].double().reshape(-1)
        d = p - t
        sums.update({"n": p.numel(), "t": float(t.sum()), "t2": float((t * t).sum()), "p": float(p.sum()),
                     "p2": float((p * p).sum()), "pt": float((p * t).sum()), "sse": float((d * d).sum()),
                     "sae": float(d.abs().sum()), "ssle": float(((torch.log1p(p) - torch.log1p(t)) ** 2).sum()),
                     "sape": float((d.abs() / t.abs()).sum()), "slc": float(torch.log(torch.cosh(d)).sum()),
                     "s3": float((d.abs() ** 3).sum())})
    n = sums["n"]
    tss = sums["t2"] - sums["t"] ** 2 / n
    err_mean = (sums["t"] - sums["p"]) / n
    ev_num = sums["sse"] / n - err_mean ** 2
    ev_den = sums["t2"] / n - (sums["t"] / n) ** 2
    cov = sums["pt"] / n - sums["p"] * sums["t"] / n ** 2
    var_p, var_t = sums["p2"] / n - (sums["p"] / n) ** 2, ev_den
    return {"mse": sums["sse"] / n, "rmse": (sums["sse"] / n) ** 0.5, "mae": sums["sae"] / n, "msle": sums["ssle"] / n,
            "mape": sums["sape"] / n, "log_cosh": sums["slc"] / n, "r2": 1 - sums["sse"] / tss,
            "explained_variance": 1 - ev_num / ev_den, "rse": sums["sse"] / tss, "minkowski3": sums["s3"] ** (1 / 3),
            "pearson": cov / (var_p * var_t) ** 0.5}


def phase_nyu_depth_v2(torch, np, dev, gen, smi: str, maps: int = NYU_MAPS, hw=NYU_HW, batch: int = NYU_BATCH) -> dict:
    """NYU Depth v2's Eigen test split: depth in [0.7, 10] m, predictions the target times exp(0.1 N(0, 1)),
    through one collection of eleven regression metrics, against float64 sums of the same pixels."""
    target = 0.7 + 9.3 * torch.rand((maps, *hw), generator=gen, device=dev)
    preds = target * torch.exp(0.1 * torch.randn((maps, *hw), generator=gen, device=dev))
    collection = nyu_collection()
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for lo in range(0, maps, batch):
        collection.update(preds[lo:lo + batch].reshape(-1), target[lo:lo + batch].reshape(-1))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    values = collection.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t1) * 1e3
    peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
    want = _nyu_float64(torch, preds, target, batch)
    errors = {k: _rel(values[k], v) for k, v in want.items()}
    for key, err in errors.items():
        check(err <= NYU_RTOL, f"nyu_depth_v2 {key} {float(values[key])} vs float64 {want[key]} (rel {err})")
    pixels = maps * hw[0] * hw[1]
    counts = {"mse_total": int(collection["mse"].total), "mape_total": float(collection["mape"].total),
              "explained_variance_num_obs": float(collection["explained_variance"].num_obs),
              "pearson_n_total": float(collection["pearson"].n_total[0])}
    check(all(v == pixels for v in counts.values()), f"nyu_depth_v2 counts {counts} != {pixels} pixels")
    updates = -(-maps // batch)
    result = {
        "phase": "nyu_depth_v2", "card": smi, "maps": maps, "hw": list(hw), "pixels": pixels, "updates": updates,
        "values": {k: float(v) for k, v in values.items()}, "float64": want, "rel_err": errors, "counts": counts,
        "groups": sorted(sorted(g) for g in collection.compute_groups.values()),
        "seconds": update_s, "pixels_per_s": pixels / update_s, "update_ms": update_s / updates * 1e3,
        "compute_ms": compute_ms, "peak_above_inputs_bytes": peak_above,
    }
    emit(result)
    return result


def sts_pairs(torch, dev, gen, n: int):
    """Gold similarity on 0-5 in steps of 0.2; a model's score, clipped to 0-5 and printed to two decimals."""
    gold = torch.randint(0, 26, (n,), generator=gen, device=dev).to(torch.float32) * 0.2
    pred = torch.round((gold + 0.8 * torch.randn(n, generator=gen, device=dev)).clamp(0, 5) * 100) / 100
    return pred, gold


def sts_collection():
    import torchmetrics_tpu_torch.regression as R
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "pearson": R.PearsonCorrCoef(), "spearman": R.SpearmanCorrCoef(), "concordance": R.ConcordanceCorrCoef(),
        **{f"kendall_{v}": R.KendallRankCorrCoef(variant=v, t_test=True) for v in "abc"},
    })


def _tau_a(np, x, y) -> float:
    i, j = np.triu_indices(len(x), k=1)
    return float(np.sum(np.sign(x[j] - x[i]) * np.sign(y[j] - y[i]))) / len(i)


def phase_stsb_sickr(torch, np, dev, gen, smi: str, sizes=(("stsb_dev", 1500), ("sickr_test", 4927)), batch: int = 32):
    """STS-B dev and SICK-R test as GLUE and SentEval report them: rho and tau against scipy, the p-values against
    the JAX package's normal approximation in float64, Pearson again after a ``merge_state`` of two halves."""
    from scipy import special, stats

    import torchmetrics_tpu_torch.regression as R

    out = {"phase": "stsb_sickr", "card": smi, "batch": batch, "sets": {}}
    for name, n in sizes:
        pred, gold = sts_pairs(torch, dev, gen, n)
        collection = sts_collection()
        torch.cuda.synchronize()
        inputs_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            collection.update(pred[lo:lo + batch], gold[lo:lo + batch])
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        values = collection.compute()
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t1) * 1e3
        peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
        x, y = pred.double().cpu().numpy(), gold.double().cpu().numpy()
        want = {"pearson": float(stats.pearsonr(x, y).statistic), "spearman": float(stats.spearmanr(x, y).statistic),
                "kendall_a": _tau_a(np, x, y), "kendall_b": float(stats.kendalltau(x, y, variant="b").statistic),
                "kendall_c": float(stats.kendalltau(x, y, variant="c").statistic)}
        mx, my = x.mean(), y.mean()
        want["concordance"] = 2 * np.mean((x - mx) * (y - my)) / (x.var() + y.var() + (mx - my) ** 2)
        var = (4 * n + 10.0) / (9.0 * n * (n - 1))
        got = {k: float(v[0] if isinstance(v, (tuple, list)) else v) for k, v in values.items()}
        errors = {k: abs(got[k] - want[k]) for k in want}
        for key in ("pearson", "spearman", "concordance"):
            check(errors[key] <= STS_RTOL * abs(want[key]), f"{name} {key} {got[key]} vs {want[key]}")
        p_errors = {}
        for variant in "abc":
            key = f"kendall_{variant}"
            check(errors[key] <= KENDALL_ATOL, f"{name} {key} {got[key]} vs scipy {want[key]}")
            p_want = 2 * (1 - special.ndtr(abs(want[key]) / var ** 0.5))
            p_errors[key] = abs(float(values[key][1]) - p_want)
            check(p_errors[key] <= KENDALL_ATOL, f"{name} {key} p-value {float(values[key][1])} vs float64 {p_want}")
        halves = [R.PearsonCorrCoef() for _ in range(2)]
        half = (n // batch // 2) * batch
        for lo in range(0, n, batch):
            halves[lo >= half].update(pred[lo:lo + batch], gold[lo:lo + batch])
        halves[0].merge_state(halves[1])
        merged = float(halves[0].compute())
        check(abs(merged - want["pearson"]) <= STS_RTOL * abs(want["pearson"]), f"{name} merged Pearson {merged}")
        out["sets"][name] = {"pairs": n, "values": got, "scipy_or_float64": want, "abs_err": errors,
                             "p_values": {f"kendall_{v}": float(values[f"kendall_{v}"][1]) for v in "abc"},
                             "p_abs_err": p_errors, "merged_pearson": merged,
                             "pairs_per_s": n / update_s, "update_ms": update_s / -(-n // batch) * 1e3,
                             "compute_ms": compute_ms, "peak_above_inputs_bytes": peak_above}
    emit(out)
    return out


def fremtpl2_data(torch, dev, gen, n: int) -> dict:
    """freMTPL2freq-shaped policies: exposure in (0.05, 1] years, Poisson claim counts (~95% zero), log-normal
    claim amounts; a model's frequency and pure premium within ~20% of the truth."""
    exposure = 0.05 + 0.95 * torch.rand(n, generator=gen, device=dev)
    rate = 0.08 * torch.exp(0.5 * torch.randn(n, generator=gen, device=dev))
    claims = torch.poisson(rate * exposure, generator=gen)
    amount = 1800.0 * torch.exp(0.8 * torch.randn(n, generator=gen, device=dev))
    pred_freq = rate * torch.exp(0.2 * torch.randn(n, generator=gen, device=dev))
    return {"freq": claims / exposure, "pred_freq": pred_freq, "pure_premium": claims * amount / exposure,
            "pred_pure_premium": pred_freq * 1800.0 * 1.377 * torch.exp(0.1 * torch.randn(n, generator=gen, device=dev))}


def _tweedie64(torch, p, t, power: float):
    if power == 1:
        return float((2 * (torch.xlogy(t, t / p) + p - t)).sum())
    term_1 = t.clamp(min=0) ** (2 - power) / ((1 - power) * (2 - power))
    term_2 = t * p ** (1 - power) / (1 - power)
    term_3 = p ** (2 - power) / (2 - power)
    return float((2 * (term_1 - term_2 + term_3)).sum())


def phase_fremtpl2_tweedie(torch, np, dev, gen, smi: str, n: int = 678_013, batch: int = 8192) -> dict:
    """Insurance pricing on freMTPL2freq's 678,013 policies, as scikit-learn's Tweedie example scores it."""
    import torchmetrics_tpu_torch.regression as R
    from torchmetrics_tpu_torch.collections import MetricCollection

    data = fremtpl2_data(torch, dev, gen, n)
    premium = MetricCollection({
        "tweedie_p1_9": R.TweedieDevianceScore(power=1.9), "mae": R.MeanAbsoluteError(), "mse": R.MeanSquaredError(),
        "wmape": R.WeightedMeanAbsolutePercentageError(), "smape": R.SymmetricMeanAbsolutePercentageError(),
    })
    frequency = R.TweedieDevianceScore(power=1)
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        premium.update(data["pred_pure_premium"][lo:lo + batch], data["pure_premium"][lo:lo + batch])
        frequency.update(data["pred_freq"][lo:lo + batch], data["freq"][lo:lo + batch])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    values = {**premium.compute(), "tweedie_p1": frequency.compute()}
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t1) * 1e3
    peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
    p, t = data["pred_pure_premium"].double(), data["pure_premium"].double()
    d = (p - t).abs()
    want = {"tweedie_p1_9": _tweedie64(torch, p, t, 1.9) / n, "mae": float(d.mean()), "mse": float((d * d).mean()),
            "wmape": float(d.sum() / t.abs().sum()), "smape": float((2 * d / (t.abs() + p.abs())).mean()),
            "tweedie_p1": _tweedie64(torch, data["pred_freq"].double(), data["freq"].double(), 1.0) / n}
    errors = {k: _rel(values[k], v) for k, v in want.items()}
    for key, err in errors.items():
        check(err <= TWEEDIE_RTOL, f"fremtpl2_tweedie {key} {float(values[key])} vs float64 {want[key]} (rel {err})")
    check(float(frequency.num_observations) == n, f"Tweedie's float32 count {float(frequency.num_observations)} != {n}")
    result = {"phase": "fremtpl2_tweedie", "card": smi, "policies": n, "batch": batch,
              "zero_share": float((data["pure_premium"] == 0).float().mean()),
              "values": {k: float(v) for k, v in values.items()}, "float64": want, "rel_err": errors,
              "seconds": update_s, "policies_per_s": n / update_s, "update_ms": update_s / -(-n // batch) * 1e3,
              "compute_ms": compute_ms, "peak_above_inputs_bytes": peak_above}
    emit(result)
    return result


SEVIR_THRESHOLDS = (16, 74, 133, 160, 181, 219)  # VIL levels on the 0-255 scale, as Earthformer scores SEVIR


def sevir_batch(torch, dev, gen, seqs: int, frames: int, side: int):
    """VIL-like uint8 frames (mostly weak echoes, a tail of storm cells) and a forecast within ~±40 levels."""
    target = (255 * torch.rand((seqs, frames, side, side), generator=gen, device=dev) ** 3).to(torch.int16)
    noise = torch.randint(-40, 41, target.shape, generator=gen, device=dev, dtype=torch.int16)
    return (target + noise).clamp(0, 255).to(torch.uint8), target.to(torch.uint8)


def phase_sevir_csi(torch, np, dev, gen, smi: str, seqs: int = 1024, batch: int = 16, frames: int = 12,
                    side: int = 384) -> dict:
    """SEVIR nowcasting scored as Earthformer scores it: CSI at six VIL thresholds over 12 output frames, and one
    threshold per sequence (``keep_sequence_dim``); hits, misses and false alarms exact against int64 counts."""
    import torchmetrics_tpu_torch.regression as R
    from torchmetrics_tpu_torch.collections import MetricCollection

    data = [sevir_batch(torch, dev, gen, batch, frames, side) for _ in range(0, seqs, batch)]
    metrics = MetricCollection({**{f"csi_{th}": R.CriticalSuccessIndex(th) for th in SEVIR_THRESHOLDS},
                                "csi_74_per_sequence": R.CriticalSuccessIndex(74, keep_sequence_dim=True)})
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for preds, target in data:
        metrics.update(preds, target)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    values = metrics.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t1) * 1e3
    peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
    # the reference: one int64 bincount of (pred >= th, target >= th) codes a threshold, and a per-sequence one
    ref = {th: torch.zeros(4, dtype=torch.int64, device=dev) for th in SEVIR_THRESHOLDS}
    per_seq = []
    for preds, target in data:
        for th in SEVIR_THRESHOLDS:
            code = (preds >= th).to(torch.int64) * 2 + (target >= th).to(torch.int64)
            ref[th] += torch.bincount(code.reshape(-1), minlength=4)
            if th == 74:
                seq = torch.arange(batch, device=dev).reshape(-1, 1, 1, 1) * 4
                per_seq.append(torch.bincount((code + seq).reshape(-1), minlength=4 * batch).reshape(batch, 4))
    errors, counts = {}, {}
    for th in SEVIR_THRESHOLDS:
        m = metrics[f"csi_{th}"]
        hits, misses, false_alarms = int(ref[th][3]), int(ref[th][1]), int(ref[th][2])
        got = (int(m.hits), int(m.misses), int(m.false_alarms))
        check(got == (hits, misses, false_alarms), f"CSI at {th}: counts {got} != int64 ({hits}, {misses}, {false_alarms})")
        want = hits / (hits + misses + false_alarms)
        errors[th] = _rel(values[f"csi_{th}"], want)
        check(errors[th] <= CSI_RTOL, f"CSI at {th}: {float(values[f'csi_{th}'])} vs {want}")
        counts[th] = got
    seq_ref = torch.cat(per_seq)
    m = metrics["csi_74_per_sequence"]
    check(torch.equal(torch.cat(m.hits), seq_ref[:, 3]) and torch.equal(torch.cat(m.misses), seq_ref[:, 1])
          and torch.equal(torch.cat(m.false_alarms), seq_ref[:, 2]), "per-sequence CSI counts != int64 counts")
    seq_want = seq_ref[:, 3].double() / seq_ref[:, 1:].sum(1).double()
    seq_err = float(((values["csi_74_per_sequence"].double() - seq_want).abs() / seq_want).max())
    check(seq_err <= CSI_RTOL, f"per-sequence CSI {seq_err} from float64")
    pixels = seqs * frames * side * side
    result = {"phase": "sevir_csi", "card": smi, "sequences": seqs, "frames": frames, "side": side, "batch": batch,
              "pixels": pixels, "counts": {str(k): v for k, v in counts.items()},
              "values": {str(th): float(values[f"csi_{th}"]) for th in SEVIR_THRESHOLDS}, "rel_err": errors,
              "per_sequence_rel_err": seq_err, "seconds": update_s, "sequences_per_s": seqs / update_s,
              "pixels_per_s": pixels / update_s, "update_ms": update_s / len(data) * 1e3, "compute_ms": compute_ms,
              "peak_above_inputs_bytes": peak_above}
    emit(result)
    return result


def _pairwise_float64(torch, name: str, x, y, exponent: float = 3.0):
    """Rows of ``x`` against all of ``y`` in float64, in row chunks of 16."""
    x, y = x.double(), y.double()
    if name == "cosine":
        return (x / x.norm(dim=1, keepdim=True)) @ (y / y.norm(dim=1, keepdim=True)).T
    if name == "linear":
        return x @ y.T
    if name == "euclidean":
        return torch.cdist(x, y)
    chunks = []
    for lo in range(0, x.shape[0], 16):
        diff = (x[lo:lo + 16, None, :] - y[None]).abs()
        chunks.append(diff.sum(-1) if name == "manhattan" else (diff ** exponent).sum(-1) ** (1 / exponent))
    return torch.cat(chunks)


def phase_embeddings_pairwise(torch, np, dev, gen, smi: str, logits, n: int = 10_000, n_l1: int = 2048, d: int = 768,
                              pairs: int = 50_000, checked_rows: int = 256) -> dict:
    """Dense retrieval embeddings at BERT-base width: the five pairwise functions, ``CosineSimilarity`` over 50,000
    pairs and ``KLDivergence`` of the imagenet_val logits' softmax against a seeded teacher's, against float64;
    the matrix products must not move with ``torch.backends.cuda.matmul.allow_tf32``."""
    import torchmetrics_tpu_torch.functional.pairwise as P
    import torchmetrics_tpu_torch.regression as R

    common = torch.randn(d, generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev) + 0.5 * common  # embeddings share a direction, as BERT's do
    y = torch.randn((n, d), generator=gen, device=dev) + 0.5 * common
    rows = torch.randperm(n_l1, generator=gen, device=dev)[:checked_rows]
    functions = {"cosine": (P.pairwise_cosine_similarity, n), "euclidean": (P.pairwise_euclidean_distance, n),
                 "linear": (P.pairwise_linear_similarity, n), "manhattan": (P.pairwise_manhattan_distance, n_l1),
                 "minkowski3": (lambda a, b: P.pairwise_minkowski_distance(a, b, exponent=3), n_l1)}
    out = {"phase": "embeddings_pairwise", "card": smi, "d": d, "functions": {}}
    for name, (fn, size) in functions.items():
        a, b = x[:size], y[:size]
        torch.cuda.synchronize()
        inputs_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = fn(a, b)
        torch.cuda.synchronize()
        peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
        ms = median_ms(torch, lambda: fn(a, b), reps=3, warmup=1)
        want = _pairwise_float64(torch, name.rstrip("3"), a[rows], b)
        err = float((result[rows].double() - want).abs().max() / want.abs().max())
        check(err <= PAIRWISE_RTOL, f"pairwise {name}: {err} of the largest value from float64")
        flops = 2 * size * size * d if name in ("cosine", "euclidean", "linear") else 3 * size * size * d
        out["functions"][name] = {"shape": [size, size, d], "ms": ms, "gflop_per_s": flops / ms / 1e6,
                                  "rel_err": err, "peak_above_inputs_bytes": peak_above}
        del result
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        full = [P.pairwise_linear_similarity(x[:2048], y[:2048]), P.pairwise_cosine_similarity(x[:2048], y[:2048])]
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = [P.pairwise_linear_similarity(x[:2048], y[:2048]), P.pairwise_cosine_similarity(x[:2048], y[:2048])]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    check(all(torch.equal(a, b) for a, b in zip(full, tf32)), "a pairwise product moved with allow_tf32")
    out["tf32_flag_moves_result"] = False

    preds = torch.randn((pairs, d), generator=gen, device=dev) + 0.5 * common
    target = preds + 0.7 * torch.randn((pairs, d), generator=gen, device=dev)
    cosine = R.CosineSimilarity(reduction="mean")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, pairs, 5000):
        cosine.update(preds[lo:lo + 5000], target[lo:lo + 5000])
    torch.cuda.synchronize()
    cos_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    got = float(cosine.compute())
    cos_compute_ms = (time.perf_counter() - t1) * 1e3
    p64, t64 = preds.double(), target.double()
    want = float(((p64 * t64).sum(1) / (p64.norm(dim=1) * t64.norm(dim=1))).mean())
    check(_rel(got, want) <= PAIRWISE_RTOL, f"CosineSimilarity {got} vs float64 {want}")
    out["cosine_similarity"] = {"pairs": pairs, "value": got, "float64": want, "rel_err": _rel(got, want),
                                "pairs_per_s": pairs / cos_s, "update_ms": cos_s / -(-pairs // 5000) * 1e3,
                                "compute_ms": cos_compute_ms}

    teacher = logits * 0.7 + torch.randn(logits.shape, generator=gen, device=dev)
    out["kl_divergence"] = {}
    for log_prob in (False, True):
        p = torch.log_softmax(logits, 1) if log_prob else torch.softmax(logits, 1)
        q = torch.log_softmax(teacher, 1) if log_prob else torch.softmax(teacher, 1)
        kl = R.KLDivergence(log_prob=log_prob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, p.shape[0], 1000):
            kl.update(p[lo:lo + 1000], q[lo:lo + 1000])
        torch.cuda.synchronize()
        kl_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        got = float(kl.compute())
        kl_compute_ms = (time.perf_counter() - t1) * 1e3
        p64, q64 = p.double(), q.double()
        if log_prob:
            want = float((p64.exp() * (p64 - q64)).sum(1).mean())
        else:
            p64, q64 = p64 / p64.sum(1, keepdim=True), q64 / q64.sum(1, keepdim=True)
            q64 = q64.clamp(min=float(np.finfo(np.float32).eps))
            want = float(torch.xlogy(p64, p64 / q64).sum(1).mean())
        check(_rel(got, want) <= KL_RTOL, f"KLDivergence(log_prob={log_prob}) {got} vs float64 {want}")
        out["kl_divergence"][f"log_prob={log_prob}"] = {"value": got, "float64": want, "rel_err": _rel(got, want),
                                                         "rows_per_s": p.shape[0] / kl_s,
                                                         "update_ms": kl_s / -(-p.shape[0] // 1000) * 1e3,
                                                         "compute_ms": kl_compute_ms}
    emit(out)
    return out


def msmarco_data(torch, dev, gen, queries: int, depth: int, batch: int) -> list:
    """MS MARCO dev's passage ranking shape: ``depth`` BM25 candidates a query, 0-3 relevant (1.07 on average),
    scores printed to two decimals (ties), ~1% of the rows ``ignore_index=-1``; each update's rows shuffled."""
    updates = []
    for lo in range(0, queries, batch):
        q = min(batch, queries - lo)
        u = torch.rand(q, generator=gen, device=dev)
        n_rel = (u >= 0.03).to(torch.int64) + (u >= 0.91).to(torch.int64) + (u >= 0.99).to(torch.int64)
        target = (torch.arange(depth, device=dev)[None, :] < n_rel[:, None]).to(torch.int64)
        boost = 2 + 8 * torch.rand((q, depth), generator=gen, device=dev)  # a relevant passage scores higher
        scores = 15 + 3 * torch.randn((q, depth), generator=gen, device=dev) + boost * target
        scores = torch.round(scores * 100) / 100
        target[torch.rand((q, depth), generator=gen, device=dev) < 0.01] = -1
        indexes = (lo + torch.arange(q, device=dev))[:, None].expand(q, depth)
        order = torch.randperm(q * depth, generator=gen, device=dev)
        updates.append(tuple(a.reshape(-1)[order] for a in (scores, target, indexes)))
    return updates


def msmarco_collection():
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.retrieval import (RetrievalAUROC, RetrievalFallOut, RetrievalHitRate, RetrievalMAP,
                                                  RetrievalMRR, RetrievalNormalizedDCG, RetrievalPrecision,
                                                  RetrievalRecall, RetrievalRPrecision)

    return MetricCollection({
        "mrr@10": RetrievalMRR(top_k=10, ignore_index=-1),
        "ndcg@10": RetrievalNormalizedDCG(top_k=10, ignore_index=-1),
        "precision@10": RetrievalPrecision(top_k=10, ignore_index=-1),
        "hit_rate@10": RetrievalHitRate(top_k=10, ignore_index=-1),
        "fall_out@10": RetrievalFallOut(top_k=10, ignore_index=-1),
        "recall@100": RetrievalRecall(top_k=100, ignore_index=-1),
        "recall@1000": RetrievalRecall(top_k=1000, ignore_index=-1),
        "map_skip": RetrievalMAP(empty_target_action="skip", ignore_index=-1),
        "r_precision": RetrievalRPrecision(ignore_index=-1),
        "auroc_median": RetrievalAUROC(aggregation="median", ignore_index=-1),
    })


def _host_retrieval(queries: list) -> dict:
    """Per-query values of the msmarco_dev metrics by plain numpy loops, float64, NaN where a query is empty."""
    import numpy as np

    names = ("mrr@10", "ndcg@10", "precision@10", "hit_rate@10", "fall_out@10", "recall@100", "recall@1000",
             "map_skip", "r_precision", "auroc_median")
    out = {name: [] for name in names}
    discount = 1.0 / np.log2(np.arange(10) + 2.0)
    for p, t in queries:
        order = np.argsort(-p, kind="stable")
        s, rel = p[order], t[order] > 0
        n_rel, n_irrel = int(rel.sum()), int((~rel).sum())
        top10 = rel[:10]
        hits = np.flatnonzero(top10)
        out["mrr@10"].append(1.0 / (hits[0] + 1) if len(hits) else 0.0)
        out["precision@10"].append(top10.sum() / 10)
        out["hit_rate@10"].append(float(top10.any()))
        out["fall_out@10"].append((~top10).sum() / n_irrel if n_irrel else np.nan)
        # nDCG@10: every run of tied scores shares the mean of its positions' discounts
        disc = np.zeros(len(s))
        disc[:10] = discount[: len(s)]
        run = np.concatenate([[0], np.cumsum(s[1:] != s[:-1])])
        mean_disc = (np.bincount(run, disc) / np.bincount(run))[run]
        ideal = (np.sort(rel.astype(np.float64))[::-1][:10] * discount[: min(10, len(s))]).sum()
        for name, value in (("recall@100", rel[:100].sum() / max(n_rel, 1)), ("recall@1000", rel[:1000].sum() / max(n_rel, 1)),
                            ("ndcg@10", (rel * mean_disc).sum() / ideal if ideal else 0.0),
                            ("map_skip", (np.cumsum(rel)[rel] / (np.flatnonzero(rel) + 1)).sum() / max(n_rel, 1)),
                            ("r_precision", rel[:n_rel].sum() / max(n_rel, 1))):
            out[name].append(value if n_rel else np.nan)
        if n_rel and n_irrel:
            values, inverse, counts = np.unique(p, return_inverse=True, return_counts=True)
            ranks = (np.cumsum(counts) - counts + (counts + 1) / 2.0)[inverse]
            out["auroc_median"].append((ranks[t > 0].sum() - n_rel * (n_rel + 1) / 2) / (n_rel * n_irrel))
        else:
            out["auroc_median"].append(np.nan)
    return {name: np.asarray(v, np.float64) for name, v in out.items()}


def _host_queries(np, updates: list) -> list:
    """The rows on the host, ignored ones dropped, grouped by query in order of arrival."""
    p, t, idx = (np.concatenate([u[i].cpu().numpy() for u in updates]) for i in range(3))
    keep = t != -1
    p, t, idx = p[keep], t[keep], idx[keep]
    order = np.argsort(idx, kind="stable")
    bounds = np.cumsum(np.unique(idx[order], return_counts=True)[1])[:-1]
    return list(zip(np.split(p[order], bounds), np.split(t[order], bounds)))


def _aggregate_host(np, per_query: dict) -> dict:
    """The reference's reductions: empty queries score 0 (``neg``), FallOut's 1 (``pos``), MAP drops them (``skip``)."""
    out = {}
    for name, v in per_query.items():
        if name == "fall_out@10":
            out[name] = float(np.where(np.isnan(v), 1.0, v).mean())
        elif name == "map_skip":
            out[name] = float(v[~np.isnan(v)].mean())
        elif name == "auroc_median":
            filled = np.sort(np.where(np.isnan(v), 0.0, v))
            out[name] = float(filled[(len(filled) - 1) // 2])
        else:
            out[name] = float(np.where(np.isnan(v), 0.0, v).mean())
    return out


def phase_msmarco_dev(torch, np, dev, gen, smi: str, pool, queries: int = MSMARCO_QUERIES,
                      depth: int = MSMARCO_DEPTH, batch: int = MSMARCO_BATCH) -> dict:
    """MS MARCO dev passage ranking: MRR@10 as the leaderboard reports it and nine more retrieval metrics in one
    collection over 6,980 queries x 1,000 candidates, against plain per-query numpy loops in worker processes."""
    updates = msmarco_data(torch, dev, gen, queries, depth, batch)
    host = _host_queries(np, updates)
    step = -(-len(host) // 4)
    pending = [pool.submit(_host_retrieval, host[lo:lo + step]) for lo in range(0, len(host), step)]
    collection = msmarco_collection()
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for preds, target, indexes in updates:
        collection.update(preds, target, indexes)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    values, compute_ms = {}, {}
    for name, metric in collection.items():
        t1 = time.perf_counter()
        values[name] = float(metric.compute())
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t1) * 1e3
    peak_above = torch.cuda.max_memory_allocated() - inputs_bytes
    parts = [f.result() for f in pending]
    want = _aggregate_host(np, {k: np.concatenate([part[k] for part in parts]) for k in parts[0]})
    errors = {k: abs(values[k] - v) for k, v in want.items()}
    for key, err in errors.items():
        check(err <= RETRIEVAL_ATOL, f"msmarco_dev {key} {values[key]} vs per-query numpy {want[key]}")
    rows = queries * depth
    result = {"phase": "msmarco_dev", "card": smi, "queries": queries, "candidates": depth, "rows": rows,
              "ignored_rows": rows - sum(len(p) for p, _ in host),
              "empty_queries": int(sum(not (t > 0).any() for _, t in host)),
              "values": values, "per_query_numpy": want, "abs_err": errors,
              "groups": sorted(sorted(g) for g in collection.compute_groups.values()),
              "seconds": update_s, "rows_per_s": rows / update_s, "queries_per_s": queries / update_s,
              "update_ms": update_s / len(updates) * 1e3, "compute_ms": compute_ms,
              "peak_above_inputs_bytes": peak_above}
    emit(result)
    return result


def regression_retrieval(torch, np, dev, gen, smi: str, counters: dict, t_main: float, logits) -> dict:
    """Phases 33-38 with the retrieval references in worker processes; none of B1-B5 may launch."""
    t0 = time.perf_counter()
    for counter in counters.values():
        counter.launches.reset()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        warm = [pool.submit(_host_retrieval, []) for _ in range(4)]  # the workers start while the card works
        phase_nyu_depth_v2(torch, np, dev, gen, smi)
        phase_stsb_sickr(torch, np, dev, gen, smi)
        phase_fremtpl2_tweedie(torch, np, dev, gen, smi)
        phase_sevir_csi(torch, np, dev, gen, smi)
        phase_embeddings_pairwise(torch, np, dev, gen, smi, logits)
        for future in warm:
            future.result()
        phase_msmarco_dev(torch, np, dev, gen, smi, pool)
    launches = {name: int(counter.launches) for name, counter in counters.items()}
    check(not any(launches.values()), f"regression, pairwise and retrieval launched {launches}")
    out = {"phase": "regression_retrieval", "seconds": time.perf_counter() - t0,
           "seconds_since_start": time.perf_counter() - t_main, "kernel_launches": launches}
    emit(out)
    return out


# --------------------------- clustering, nominal association and the wrappers (phases 39-43)
CLUSTER_RTOL = 1e-5  # float32 sums over a 1000 x 1000 contingency (and float32 pair counts) against float64
AMI_ATOL = 1e-5  # AMI: float32 MI and entropies around a float64 EMI
INTRINSIC_RTOL = 1e-5  # float32 centroid sums of ~50 rows of 2,048 features, against float64 on the card
NOMINAL_ATOL = 1e-5  # float32 chi-squared sums and entropies of 48,842 rows against float64 numpy
FLEISS_ATOL = 1e-6  # float32 sums of 10,000 per-subject agreements against float64
BOOT_ATOL = 1e-6  # a float32 macro mean of 1000 per-class recalls from exact counts, against float64
ADULT_CATEGORIES = (9, 16, 7, 15, 6, 5, 2, 42, 2)  # adult.names: workclass .. native-country, "?" counted
ADULT_ROWS = 48_842  # adult.data + adult.test


def _entropy64(np, counts) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


def _host_emi(a, b, n: int) -> float:
    """E[MI] of sklearn's expected_mutual_information in float64 numpy, a row of the contingency at a time,
    with log-gamma from scipy; an independent reference for the port's chunked sum on the card."""
    import numpy as np
    from scipy.special import gammaln

    lg = gammaln(np.arange(n + 2, dtype=np.float64))  # lg[k] = log((k - 1)!)
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    total = 0.0
    for ai in a:
        start = np.maximum(1, ai + b - n)
        count = np.maximum(0, np.minimum(ai, b) - start + 1)
        col = np.repeat(np.arange(len(b)), count)
        nij = np.repeat(start, count) + (np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count))
        bj = b[col]
        term1 = nij / n * (np.log(nij) - np.log(ai) - np.log(bj) + np.log(n))
        gln = (lg[ai + 1] + lg[bj + 1] + lg[n - ai + 1] + lg[n - bj + 1] - lg[n + 1] - lg[nij + 1]
               - lg[ai - nij + 1] - lg[bj - nij + 1] - lg[n - ai - bj + nij + 1])
        total += float((term1 * np.exp(gln)).sum())
    return total


def _host_extrinsic(preds, target) -> dict:
    """The nine extrinsic scores in float64 from an int64 contingency, and the exact pair counts (Python ints);
    run in a worker process while the card works."""
    import numpy as np

    _, p = np.unique(preds, return_inverse=True)
    _, t = np.unique(target, return_inverse=True)
    kp, kt, n = p.max() + 1, t.max() + 1, len(p)
    c = np.bincount(t * kp + p, minlength=kt * kp).reshape(kt, kp).astype(np.int64)
    a, b = c.sum(axis=1), c.sum(axis=0)
    nz = c > 0
    mi = float((c[nz] / n * (np.log(c[nz] * n) - np.log(np.outer(a, b)[nz]))).sum())
    h_t, h_p = _entropy64(np, a.astype(np.float64)), _entropy64(np, b.astype(np.float64))
    h_t_given_p = float(-(c[nz] / n * (np.log(c[nz]) - np.log(np.broadcast_to(b, c.shape)[nz]))).sum())
    h_p_given_t = float(-(c[nz] / n * (np.log(c[nz]) - np.log(np.broadcast_to(a[:, None], c.shape)[nz]))).sum())
    hom, com = 1.0 - h_t_given_p / h_t, 1.0 - h_p_given_t / h_p
    sq = int((c.astype(object) ** 2).sum())
    rows, cols = int((a.astype(object) ** 2).sum()), int((b.astype(object) ** 2).sum())
    tp, fp, fn = sq - n, rows - sq, cols - sq  # fp: the row marginals, as the package orients [0, 1]
    tn = n * n - tp - fp - fn - n
    emi = _host_emi(a, b, n)
    return {
        "contingency": c, "pairs": [[tn, fp], [fn, tp]], "emi": emi, "emi_terms": int(sum(
            np.maximum(0, np.minimum(ai, b) - np.maximum(1, ai + b - n) + 1).sum() for ai in a)),
        "MutualInfoScore": mi, "NormalizedMutualInfoScore": mi / ((h_t + h_p) / 2),
        "AdjustedMutualInfoScore": (mi - emi) / ((h_t + h_p) / 2 - emi),
        "RandScore": (tn + tp) / (n * n - n), "AdjustedRandScore": 2.0 * (tp * tn - fn * fp) / (
            (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)),
        "HomogeneityScore": hom, "CompletenessScore": com, "VMeasureScore": 2 * hom * com / (hom + com),
        "FowlkesMallowsIndex": tp / ((tp + fp) * (tp + fn)) ** 0.5,
    }


def imagenet_clusters(torch, dev, gen, n: int, classes: int, keep: float = 0.6):
    """ImageNet-1k val's labels and a synthetic k-means assignment: the true class with probability ``keep``."""
    target = torch.randint(0, classes, (n,), generator=gen, device=dev)
    other = torch.randint(0, classes, (n,), generator=gen, device=dev)
    return torch.where(torch.rand(n, generator=gen, device=dev) < keep, target, other), target


def phase_clustering_imagenet(torch, np, preds, target, pending, smi: str, batch: int = 1024) -> dict:
    """NMI, AMI, ARI and six more on ImageNet-1k val's 50,000 labels and 1000 clusters, as deep-clustering papers
    (SCAN, TEMI) report them; against float64 from an int64 contingency and a numpy EMI in a worker process."""
    import torchmetrics_tpu_torch.clustering as CL
    import torchmetrics_tpu_torch.functional.clustering as CLF
    from torchmetrics_tpu_torch.functional.clustering import (calculate_contingency_matrix,
                                                              calculate_pair_cluster_confusion_matrix)

    ext = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.extrinsic")
    names = ["MutualInfoScore", "NormalizedMutualInfoScore", "AdjustedMutualInfoScore", "RandScore",
             "AdjustedRandScore", "HomogeneityScore", "CompletenessScore", "VMeasureScore", "FowlkesMallowsIndex"]
    metrics = {name: getattr(CL, name)() for name in names}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(target), batch):
        for metric in metrics.values():
            metric.update(preds[lo:lo + batch], target[lo:lo + batch])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    values, compute_ms, warm_ms = {}, {}, {}
    for name, metric in metrics.items():
        t1 = time.perf_counter()
        values[name] = float(metric.compute())
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t1) * 1e3
    for name in names:  # again through the functional: the first computes load each CUDA module once
        fn = getattr(CLF, re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower())  # VMeasureScore: v_measure_score
        t1 = time.perf_counter()
        fn(preds, target)
        torch.cuda.synchronize()
        warm_ms[name] = (time.perf_counter() - t1) * 1e3
    contingency = calculate_contingency_matrix(preds, target)
    n = len(target)
    t1 = time.perf_counter()
    emi = ext.expected_mutual_info_score(contingency, n)
    torch.cuda.synchronize()
    emi_ms = (time.perf_counter() - t1) * 1e3
    pairs = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    ref = pending.result()
    check(np.array_equal(contingency.cpu().numpy(), ref["contingency"]) and int(contingency.max()) < 2**24,
          "contingency != int64 bincount")
    pair_err = max(abs(float(pairs[i, j]) - ref["pairs"][i][j]) / ref["pairs"][i][j] for i in (0, 1) for j in (0, 1))
    errors = {name: (abs(values[name] - ref[name]) if name == "AdjustedMutualInfoScore" else _rel(values[name], ref[name]))
              for name in names}
    for name in names:
        limit = AMI_ATOL if name == "AdjustedMutualInfoScore" else CLUSTER_RTOL
        check(errors[name] <= limit, f"{name} {values[name]} vs float64 {ref[name]}")
    emi_err = _rel(emi, ref["emi"])
    check(emi_err <= 1e-9, f"EMI {emi} vs numpy float64 {ref['emi']}")
    result = {"phase": "clustering_imagenet", "card": smi, "samples": n, "classes": int(target.max()) + 1,
              "clusters": int(preds.max()) + 1, "batch": batch, "values": values, "float64": {k: ref[k] for k in names},
              "errors": errors, "pair_counts_float32_rel_err": pair_err, "emi": emi, "emi_float64_numpy": ref["emi"],
              "emi_rel_err": emi_err, "emi_terms": ref["emi_terms"], "emi_ms": emi_ms, "compute_ms": compute_ms,
              "warm_functional_ms": warm_ms, "updates_s": update_s}
    emit(result)
    return result


def _intrinsic_float64(torch, data, labels) -> dict:
    """Calinski-Harabasz, Davies-Bouldin and Dunn (p=2) in float64 on the card; centroid distances by the float64
    Gram identity, another route than the port's tiled differences."""
    _, lab = torch.unique(labels, return_inverse=True)
    k = int(lab.max()) + 1
    x = data.double()
    counts = torch.bincount(lab, minlength=k).double()
    cent = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device).index_add_(0, lab, x) / counts[:, None]
    resid = ((x - cent[lab]) ** 2).sum(dim=1)
    between = (counts * ((cent - x.mean(dim=0)) ** 2).sum(dim=1)).sum()
    ch = float(between / resid.sum() * (len(x) - k) / (k - 1))
    scatter = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, lab, resid.sqrt()) / counts
    sq = (cent * cent).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * cent @ cent.T).clamp_(min=0.0)
    dist = d2.sqrt()
    ratio = (scatter[:, None] + scatter[None, :]) / dist
    ratio.fill_diagonal_(-float("inf"))
    db = float(ratio.max(dim=1).values.mean())
    dist.fill_diagonal_(float("inf"))
    dunn = float(dist.min() / resid.sqrt().max())
    return {"CalinskiHarabaszScore": ch, "DaviesBouldinScore": db, "DunnIndex": dunn}


def phase_clustering_features(torch, dev, gen, labels, smi: str, dim: int = 2048, batch: int = 1024) -> dict:
    """The intrinsic scores of the same 1000-cluster assignment over ResNet-50-wide (2,048) float32 features."""
    import torchmetrics_tpu_torch.clustering as CL

    centers = torch.randn((int(labels.max()) + 1, dim), generator=gen, device=dev)
    data = centers[labels] + 2.0 * torch.randn((len(labels), dim), generator=gen, device=dev)
    del centers
    metrics = {name: getattr(CL, name)() for name in ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")}
    for lo in range(0, len(labels), batch):
        for metric in metrics.values():
            metric.update(data[lo:lo + batch], labels[lo:lo + batch])
    torch.cuda.synchronize()
    inputs_bytes = torch.cuda.memory_allocated()
    values, compute_ms, peak = {}, {}, {}
    for name, metric in metrics.items():
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        values[name] = float(metric.compute())
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t1) * 1e3
        peak[name] = torch.cuda.max_memory_allocated() - inputs_bytes
    import torchmetrics_tpu_torch.functional.clustering as CLF

    warm_ms = {}
    for name, fn in (("CalinskiHarabaszScore", CLF.calinski_harabasz_score),
                     ("DaviesBouldinScore", CLF.davies_bouldin_score), ("DunnIndex", CLF.dunn_index)):
        t1 = time.perf_counter()
        fn(data, labels)
        torch.cuda.synchronize()
        warm_ms[name] = (time.perf_counter() - t1) * 1e3
    ref = _intrinsic_float64(torch, data, labels)
    errors = {name: _rel(values[name], ref[name]) for name in values}
    for name in values:
        check(errors[name] <= INTRINSIC_RTOL, f"{name} {values[name]} vs float64 {ref[name]}")
    result = {"phase": "clustering_features", "card": smi, "samples": len(labels), "dim": dim,
              "features_bytes": data.numel() * 4, "values": values, "float64": ref, "rel_err": errors,
              "compute_ms": compute_ms, "warm_functional_ms": warm_ms, "peak_above_inputs_bytes": peak,
              "jax_form_centroid_differences_bytes": (int(labels.max()) + 1) ** 2 * dim * 4}
    emit(result)
    return result


def adult_columns(torch, dev, gen, rows: int = ADULT_ROWS, categories=ADULT_CATEGORIES):
    """UCI Adult's categorical columns (category counts as adult.names lists them): each drawn from a shared latent
    rank or uniformly, so the columns are associated but not equal."""
    latent = torch.rand(rows, generator=gen, device=dev)
    cols = []
    for k in categories:
        tied = (latent * k).long().clamp_(max=k - 1)
        free = torch.randint(0, k, (rows,), generator=gen, device=dev)
        cols.append(torch.where(torch.rand(rows, generator=gen, device=dev) < 0.5, tied, free))
    return torch.stack(cols, dim=1)


def _host_nominal(np, x, y) -> dict:
    """Cramér's V and Tschuprow's T (bias-corrected), Pearson's C and Theil's U(x | y), float64 from int64 counts."""
    _, xi = np.unique(x, return_inverse=True)
    _, yi = np.unique(y, return_inverse=True)
    r, k = xi.max() + 1, yi.max() + 1
    c = np.bincount(xi * k + yi, minlength=r * k).reshape(r, k).astype(np.float64)
    n = c.sum()
    expected = np.outer(c.sum(axis=1), c.sum(axis=0)) / n
    chi2 = float(((c - expected) ** 2 / expected).sum())
    phi2 = max(0.0, chi2 / n - (r - 1) * (k - 1) / (n - 1))
    rc, kc = r - (r - 1) ** 2 / (n - 1), k - (k - 1) ** 2 / (n - 1)
    px, py, pj = c.sum(axis=1) / n, c.sum(axis=0) / n, c / n
    h_x = float(-(px[px > 0] * np.log(px[px > 0])).sum())
    nz = pj > 0
    h_x_given_y = float(-(pj[nz] * (np.log(pj[nz]) - np.log(np.broadcast_to(py, pj.shape)[nz]))).sum())
    return {"cramers_v": (phi2 / min(rc - 1, kc - 1)) ** 0.5, "tschuprows_t": (phi2 / ((rc - 1) * (kc - 1)) ** 0.5) ** 0.5,
            "pearsons_contingency_coefficient": (chi2 / (chi2 + n)) ** 0.5,
            "theils_u": 0.0 if h_x == 0 else (h_x - h_x_given_y) / h_x}


def phase_nominal_adult(torch, np, dev, gen, smi: str, batch: int = 4096) -> dict:
    """The four association matrices over UCI Adult's nine categorical columns, the four pair classes streamed
    with and without ``num_classes``, and both NaN strategies, against float64 numpy."""
    import torchmetrics_tpu_torch.functional.nominal as NF
    import torchmetrics_tpu_torch.nominal as NC

    cols = adult_columns(torch, dev, gen)
    host = cols.cpu().numpy()
    fns = ("cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u")
    v = host.shape[1]
    refs = {(i, j): _host_nominal(np, host[:, i], host[:, j]) for i in range(v) for j in range(v) if i != j}
    matrix_ms, errors = {}, {}
    for fn in fns:
        t1 = time.perf_counter()
        out = getattr(NF, fn + "_matrix")(cols)
        torch.cuda.synchronize()
        matrix_ms[fn] = (time.perf_counter() - t1) * 1e3
        want = np.ones((v, v))
        for (i, j), ref in refs.items():
            want[i, j] = ref[fn]
        check(out.dtype == torch.float32 and out.device == cols.device, f"{fn}_matrix on {out.device} as {out.dtype}")
        errors[fn + "_matrix"] = float(np.abs(out.cpu().numpy() - want).max())
        check(errors[fn + "_matrix"] <= NOMINAL_ATOL, f"{fn}_matrix off float64 by {errors[fn + '_matrix']}")
    # the pair classes on native-country (42) against occupation (16), streamed
    x, y = cols[:, 7], cols[:, 1]
    classes = {"cramers_v": "CramersV", "tschuprows_t": "TschuprowsT",
               "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient", "theils_u": "TheilsU"}
    class_values = {}
    for num_classes in (42, None):
        for fn, cls in classes.items():
            metric = getattr(NC, cls)(num_classes=num_classes)
            for lo in range(0, len(x), batch):
                metric.update(x[lo:lo + batch], y[lo:lo + batch])
            got = float(metric.compute())
            key = f"{cls}_{'num_classes' if num_classes else 'cat'}"
            class_values[key] = got
            # with num_classes the state's rows are x (preds), as the functional's Theil's U conditions on y
            errors[key] = abs(got - refs[(7, 1)][fn])
            check(errors[key] <= NOMINAL_ATOL, f"{key} {got} vs float64 {refs[(7, 1)][fn]}")
    # 1% NaNs in each of the pair's columns, replaced by category 0 or dropped
    xf, yf = x.double(), y.double()
    xf[torch.rand(len(x), generator=gen, device=dev) < 0.01] = float("nan")
    yf[torch.rand(len(y), generator=gen, device=dev) < 0.01] = float("nan")
    xh, yh = xf.cpu().numpy(), yf.cpu().numpy()
    drop = ~(np.isnan(xh) | np.isnan(yh))
    nan_refs = {"replace": _host_nominal(np, np.nan_to_num(xh, nan=0.0), np.nan_to_num(yh, nan=0.0)),
                "drop": _host_nominal(np, xh[drop], yh[drop])}
    for strategy, ref in nan_refs.items():
        for fn in fns:
            got = float(getattr(NF, fn)(xf, yf, nan_strategy=strategy))
            errors[f"{fn}_{strategy}"] = abs(got - ref[fn])
            check(errors[f"{fn}_{strategy}"] <= NOMINAL_ATOL, f"{fn} with NaNs {strategy}d: {got} vs {ref[fn]}")
    result = {"phase": "nominal_adult", "card": smi, "rows": len(host), "categories": list(ADULT_CATEGORIES),
              "matrix_ms": matrix_ms, "class_values": class_values, "max_abs_err": max(errors.values()),
              "errors": errors, "nan_rows_dropped": int((~drop).sum())}
    emit(result)
    return result


def _fleiss64(np, counts) -> float:
    counts = counts.astype(np.float64)
    raters = counts.sum(axis=1).max()
    p_cat = counts.sum(axis=0) / (len(counts) * raters)
    p_bar = ((counts ** 2).sum(axis=1) - raters).mean() / (raters * (raters - 1))
    pe = (p_cat ** 2).sum()
    return float((p_bar - pe) / (1 - pe + 1e-5))


def phase_fleiss_cifar10h(torch, np, dev, gen, smi: str, images: int = 10_000, classes: int = 10,
                          raters: int = 51) -> dict:
    """Fleiss' kappa on CIFAR-10H's shape (10,000 images, 10 classes, 51 annotators an image), counts and scores."""
    import torchmetrics_tpu_torch.nominal as NC

    truth = torch.randint(0, classes, (images,), generator=gen, device=dev)
    probs = torch.full((images, classes), 0.1 / (classes - 1), device=dev)
    probs[torch.arange(images, device=dev), truth] = 0.9
    choice = torch.multinomial(probs, raters, replacement=True, generator=gen)  # (images, raters)
    counts = torch.zeros((images, classes), dtype=torch.int64, device=dev).scatter_add_(
        1, choice, torch.ones_like(choice))
    scores = torch.rand((images, classes, raters), generator=gen, device=dev)
    scores.scatter_add_(1, choice[:, None, :], torch.ones((images, 1, raters), device=dev))  # argmax = choice
    got, ms = {}, {}
    for mode, data in (("counts", counts), ("probs", scores)):
        metric = NC.FleissKappa(mode=mode)
        t1 = time.perf_counter()
        for lo in range(0, images, 1000):
            metric.update(data[lo:lo + 1000])
        got[mode] = float(metric.compute())
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t1) * 1e3
    want = _fleiss64(np, counts.cpu().numpy())
    errors = {mode: abs(value - want) for mode, value in got.items()}
    check(max(errors.values()) <= FLEISS_ATOL, f"Fleiss' kappa {got} vs float64 {want}")
    result = {"phase": "fleiss_cifar10h", "card": smi, "images": images, "classes": classes, "raters": raters,
              "kappa": got, "kappa_float64": want, "abs_err": errors, "stream_ms": ms}
    emit(result)
    return result


def _bootstrap_copies_vs_own(torch, np, Acc, BootStrapper, logits, target, batch: int, strategy: str, copies: int,
                             seed: int) -> dict:
    """The loop route: each copy against its own metric updated on the numpy-drawn indices, exactly."""
    boot = importlib.import_module("torchmetrics_tpu_torch.wrappers.bootstrapping")
    wrapper = BootStrapper(Acc(num_classes=1000), num_bootstraps=copies, sampling_strategy=strategy, seed=seed,
                           raw=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(target), batch):
        wrapper.update(logits[lo:lo + batch], target[lo:lo + batch])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    raw = wrapper.compute()["raw"]
    rng, own = np.random.default_rng(seed), [Acc(num_classes=1000) for _ in range(copies)]
    for lo in range(0, len(target), batch):
        p, t = logits[lo:lo + batch], target[lo:lo + batch]
        for metric in own:
            idx = torch.from_numpy(boot._bootstrap_sampler(len(t), strategy, rng)).to(p.device)
            if len(idx):
                metric.update(p[idx], t[idx])
    want = torch.stack([m.compute() for m in own])
    check(torch.equal(raw, want), f"{strategy} loop copies != their own metrics: {raw} vs {want}")
    check(wrapper.route_counts == {"loop": -(-len(target) // batch), "stacked": 0}, f"routes {wrapper.route_counts}")
    return {"batches_per_s": -(-len(target) // batch) / seconds, "mean": float(raw.mean()), "std": float(raw.std())}


def _bootstrap_confmat_routes(torch, np, BootStrapper, CM, logits, target, seed: int, sizes=(64, 256, 1024),
                              batches: int = 6, copies: int = 10, classes: int = 1000) -> dict:
    """BootStrapper over a 1000-class confusion matrix, each route forced at each batch size, against the route that
    ``_STACKED_DELTA_BYTES`` picks: the loop's copies equal their own metrics on the numpy-drawn indices, the stacked
    copies equal a numpy bincount weighted by the counts they drew, both exactly; ms per batch after the first (the
    loop's, untimed) and the peak memory the route allocated. The stacked route's per-sample deltas launch B1's
    lane-batched kernel once a batch."""
    boot = importlib.import_module("torchmetrics_tpu_torch.wrappers.bootstrapping")
    kernel = importlib.import_module("torchmetrics_tpu_torch.functional.classification._confmat_kernel")
    shipped_bound, out = boot._STACKED_DELTA_BYTES, {}
    pred_all, target_all = logits.argmax(dim=1).cpu().numpy(), target.cpu().numpy()
    try:
        for size in sizes:
            spans = [(b * size, (b + 1) * size) for b in range(batches)]
            res = {}
            for route, bound in (("loop", 0), ("stacked", float("inf"))):
                boot._STACKED_DELTA_BYTES = bound
                wrapper = BootStrapper(CM(num_classes=classes, validate_args=False), num_bootstraps=copies, seed=seed,
                                       raw=True)
                drawn, draw = [], wrapper._draw_counts
                wrapper._draw_counts = lambda n, _d=draw, _l=drawn: _l.append(_d(n)) or _l[-1]
                wrapper.update(logits[:size], target[:size])  # a stream's first batch takes the loop
                lanes0 = int(kernel.confusion_matrix_lanes.launches)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                for lo, hi in spans[1:]:
                    wrapper.update(logits[lo:hi], target[lo:hi])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                lanes = int(kernel.confusion_matrix_lanes.launches) - lanes0
                want_routes = {"loop": batches, "stacked": 0} if route == "loop" else {"loop": 1, "stacked": batches - 1}
                check(wrapper.route_counts == want_routes, f"confmat bootstrap {route} at {size}: {wrapper.route_counts}")
                check(lanes == (0 if route == "loop" else batches - 1),
                      f"confmat bootstrap {route} at {size}: {lanes} lane-batched B1 launches")
                raw = wrapper.compute()["raw"].cpu().numpy().astype(np.int64)
                rng = np.random.default_rng(seed)
                want = np.zeros((copies, classes * classes), np.int64)
                for b, (lo, hi) in enumerate(spans if route == "loop" else spans[:1]):
                    cells = target_all[lo:hi] * classes + pred_all[lo:hi]
                    for k in range(copies):
                        idx = boot._bootstrap_sampler(hi - lo, "poisson", rng)
                        want[k] += np.bincount(cells[idx], minlength=classes * classes)
                for counts, (lo, hi) in zip(drawn, spans[1:]):
                    cells = target_all[lo:hi] * classes + pred_all[lo:hi]
                    for k, row in enumerate(counts.cpu().numpy()):
                        want[k] += np.rint(np.bincount(cells, weights=row, minlength=classes * classes)).astype(np.int64)
                check(np.array_equal(raw.reshape(copies, -1), want),
                      f"confmat bootstrap {route} at {size}: the copies' matrices != numpy")
                res[route] = {"ms_per_batch": 1e3 * seconds / (batches - 1), "peak_gb": peak / 2**30,
                              "lane_launches": lanes}
                delta_bytes = wrapper._delta_bytes(list(wrapper.metrics[0]._defaults), size)
                del wrapper, drawn
                torch.cuda.empty_cache()
            picked = "stacked" if delta_bytes <= shipped_bound else "loop"
            faster = min(("loop", "stacked"), key=lambda r: res[r]["ms_per_batch"])
            res.update(picked=picked, faster=faster, delta_gb=delta_bytes / 2**30)
            emit({"phase": "bootstrap_confmat", "batch": size, **res})
            # the bound must not send a batch down a route that is clearly the slower one
            check(picked == faster or res[picked]["ms_per_batch"] <= 1.5 * res[faster]["ms_per_batch"],
                  f"confmat bootstrap at {size}: the bound picks {picked}, {res}")
            out[size] = res
    finally:
        boot._STACKED_DELTA_BYTES = shipped_bound
    return {"classes": classes, "copies": copies, "batches": batches, "delta_bytes_bound": shipped_bound,
            "by_batch": out}


def _macro_accuracy64(np, counts, pred, target, classes: int = 1000):
    """Macro accuracy of each copy in float64 under an (N, n) count matrix; classes without tp, fp or fn dropped."""
    correct = pred == target
    out = []
    for row in counts:
        tp = np.bincount(target, weights=row * correct, minlength=classes)
        fn = np.bincount(target, weights=row * ~correct, minlength=classes)
        fp = np.bincount(pred, weights=row * ~correct, minlength=classes)
        seen = (tp + fp + fn) > 0
        score = np.divide(tp, tp + fn, out=np.zeros(classes), where=(tp + fn) > 0)
        out.append(score[seen].mean())
    return np.array(out)


def phase_wrappers_imagenet_cifar10(torch, np, ce, dev, gen, logits, target, npz: str, smi: str, seed: int,
                                    batch: int = 1024, n_img: int = 10_000, img_batch: int = 200,
                                    stacked_copies: int = 100, kid_subset: int = 1000) -> dict:
    """BootStrapper's two routes, MetricTracker, ClasswiseWrapper, MinMaxMetric, MultioutputWrapper and
    MultitaskWrapper on the imagenet_val data, each held to the metrics run unwrapped; FeatureShare over FID, KID
    and MiFID on fid_cifar10_10k's images, one shared trunk forward a batch (FID's compiled graph runs its own
    beside it), equal to the three run alone."""
    import torchmetrics_tpu_torch as T
    from torchmetrics_tpu_torch.wrappers import (BootStrapper, ClasswiseWrapper, FeatureShare, MetricTracker,
                                                 MinMaxMetric, MultioutputWrapper, MultitaskWrapper)

    out = {"phase": "wrappers_imagenet_cifar10", "card": smi}
    n = len(target)
    batches = [(lo, min(lo + batch, n)) for lo in range(0, n, batch)]
    # --- BootStrapper, the loop route (validate_args=True): 10 copies, both strategies
    out["bootstrap_loop"] = {s: _bootstrap_copies_vs_own(torch, np, T.MulticlassAccuracy, BootStrapper, logits, target,
                                                         batch, s, 10, seed + i)
                             for i, s in enumerate(("poisson", "multinomial"))}
    # --- the stacked route (validate_args=False): 100 copies, its counts recorded as drawn
    wrapper = BootStrapper(T.MulticlassAccuracy(num_classes=1000, validate_args=False), num_bootstraps=stacked_copies,
                           seed=seed, raw=True)
    drawn, draw = [], wrapper._draw_counts
    wrapper._draw_counts = lambda size: drawn.append(draw(size)) or drawn[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in batches:
        wrapper.update(logits[lo:hi], target[lo:hi])
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    check(wrapper.route_counts == {"loop": 1, "stacked": len(batches) - 1}, f"stacked routes {wrapper.route_counts}")
    raw = wrapper.compute()["raw"].double().cpu().numpy()
    boot = importlib.import_module("torchmetrics_tpu_torch.wrappers.bootstrapping")
    rng = np.random.default_rng(seed)  # the first batch's loop draws, replayed as counts
    first = np.stack([np.bincount(boot._bootstrap_sampler(batches[0][1], "poisson", rng), minlength=batches[0][1])
                      for _ in range(stacked_copies)])
    counts = np.concatenate([first] + [c.cpu().numpy() for c in drawn], axis=1)
    pred = logits.argmax(dim=1).cpu().numpy()
    want = _macro_accuracy64(np, counts, pred, target.cpu().numpy())
    stacked_err = float(np.abs(raw - want).max())
    check(stacked_err <= BOOT_ATOL, f"stacked copies off the count-weighted float64 accuracy by {stacked_err}")
    out["bootstrap_stacked"] = {"copies": stacked_copies, "batches_per_s": len(batches) / stacked_s,
                                "max_abs_err": stacked_err, "count_mean": float(counts.mean()),
                                "routes": wrapper.route_counts}
    # --- a 1000-class confusion matrix: the two routes by batch size, against the route the bound picks
    b1 = importlib.import_module("torchmetrics_tpu_torch.functional.classification._confmat_kernel").confusion_matrix_cuda
    b1_0 = int(b1.launches)
    out["bootstrap_confmat"] = _bootstrap_confmat_routes(torch, np, BootStrapper, T.MulticlassConfusionMatrix, logits,
                                                         target, seed)
    out["b1_launches"] = int(b1.launches) - b1_0
    # --- MetricTracker over 5 epochs of 10,000 samples
    tracker = MetricTracker(T.MulticlassAccuracy(num_classes=1000))
    epochs = [(e * n // 5, (e + 1) * n // 5) for e in range(5)]
    alone = []
    for lo, hi in epochs:
        tracker.increment()
        tracker.update(logits[lo:hi], target[lo:hi])
        metric = T.MulticlassAccuracy(num_classes=1000)
        metric.update(logits[lo:hi], target[lo:hi])
        alone.append(metric.compute())
    best, step = tracker.best_metric(return_step=True)
    check(torch.equal(tracker.compute_all(), torch.stack(alone)) and step == int(torch.stack(alone).argmax())
          and float(best) == float(max(alone)), "MetricTracker != the epochs run alone")
    # --- ClasswiseWrapper, MinMaxMetric, MultioutputWrapper, MultitaskWrapper
    classwise = ClasswiseWrapper(T.MulticlassRecall(num_classes=1000, average=None))
    recall = T.MulticlassRecall(num_classes=1000, average=None)
    minmax, running = MinMaxMetric(T.MulticlassAccuracy(num_classes=1000, average="micro")), []
    accumulated = T.MulticlassAccuracy(num_classes=1000, average="micro")
    reg_t = torch.randn((n, 3), generator=gen, device=dev)
    reg_p = reg_t + 0.5 * torch.randn((n, 3), generator=gen, device=dev)
    reg_p[torch.rand((n, 3), generator=gen, device=dev) < 0.01] = float("nan")
    multi = MultioutputWrapper(T.R2Score(), 3)
    r2 = [T.R2Score() for _ in range(3)]
    task = MultitaskWrapper({"cls": T.MulticlassAccuracy(num_classes=1000), "reg": T.MeanSquaredError()})
    cls_alone, mse_alone = T.MulticlassAccuracy(num_classes=1000), T.MeanSquaredError()
    for lo, hi in batches:
        p, t = logits[lo:hi], target[lo:hi]
        classwise.update(p, t)
        recall.update(p, t)
        minmax.update(p, t)
        accumulated.update(p, t)
        running.append(float(accumulated.compute()))
        mm = minmax.compute()
        check(float(mm["raw"]) == running[-1] and float(mm["max"]) == max(running)
              and float(mm["min"]) == min(running), f"MinMaxMetric {mm} vs the running accuracy {running}")
        multi.update(reg_p[lo:hi], reg_t[lo:hi])
        for i, m in enumerate(r2):
            keep = ~torch.isnan(reg_p[lo:hi, i])
            m.update(reg_p[lo:hi, i][keep], reg_t[lo:hi, i][keep])
        y = torch.nan_to_num(reg_p[lo:hi, 0])
        task.update({"cls": p, "reg": y}, {"cls": t, "reg": reg_t[lo:hi, 0]})
        cls_alone.update(p, t)
        mse_alone.update(y, reg_t[lo:hi, 0])
    per_class = recall.compute()
    classwise_out = classwise.compute()
    check(len(classwise_out) == 1000 and all(torch.equal(classwise_out[f"multiclassrecall_{c}"], per_class[c])
                                             for c in range(1000)), "ClasswiseWrapper != MulticlassRecall")
    check(torch.equal(multi.compute(), torch.stack([m.compute() for m in r2])), "MultioutputWrapper != R2Score alone")
    task_out = task.compute()
    check(torch.equal(task_out["cls"], cls_alone.compute()) and torch.equal(task_out["reg"], mse_alone.compute()),
          "MultitaskWrapper != its tasks alone")
    out["tracker_best"] = {"value": float(best), "step": step}
    out["minmax"] = {k: float(v) for k, v in mm.items()}
    out["multioutput_r2"] = multi.compute().tolist()

    # --- FeatureShare: FID, KID and MiFID on one trunk
    real = torch.randint(0, 256, (n_img, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    noise = torch.randint(-20, 21, real.shape, generator=gen, device=dev, dtype=torch.int16)
    fake = (real.to(torch.int16) + 24 + noise).clamp_(0, 255).to(torch.uint8)

    def members():
        return [T.FrechetInceptionDistance(feature=2048, weights_path=npz),
                T.KernelInceptionDistance(feature=2048, subsets=10, subset_size=kid_subset, weights_path=npz),
                T.MemorizationInformedFrechetInceptionDistance(feature=2048, weights_path=npz)]

    def stream(update):
        counts0 = int(ce.matmul_bias_relu.launches), int(ce.bias_relu_.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n_img, img_batch):
            update(real[lo:lo + img_batch], True)
            update(fake[lo:lo + img_batch], False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, (int(ce.matmul_bias_relu.launches) - counts0[0],
                                          int(ce.bias_relu_.launches) - counts0[1])

    trunk0 = int(ce.matmul_bias_relu.launches), int(ce.bias_relu_.launches)
    shared_members = members()
    shared = FeatureShare(shared_members)
    shared_members[0].inception.network(real[:img_batch])  # lazy module loading and cuDNN heuristics, not timed
    buf = torch.empty((img_batch, 3, 32, 32), dtype=torch.uint8, device=dev)

    def shared_update(imgs, is_real):
        # one input buffer refilled every update: its version counter, not its identity, tells the cache the batch is new
        buf.copy_(imgs)
        shared.update(buf, real=is_real)

    shared_s, shared_launches = stream(shared_update)
    alone_members = members()
    alone_s, alone_launches = stream(lambda imgs, is_real: [m.update(imgs, real=is_real) for m in alone_members])
    forwards = 2 * n_img // img_batch
    # the members stay eager (where the JAX runtime compiles FID): one cached trunk forward a batch serves all three,
    # and the trunk replays its own graph from its second call
    shared_forwards = forwards
    check(all(m._auto_disabled and "FeatureShare" in m._auto_disabled_reason for m in shared_members),
          "a FeatureShare member compiles")
    check(shared_launches == (40 * shared_forwards, 54 * shared_forwards),
          f"shared trunk launches {shared_launches}, {forwards} batches, {shared_forwards} forwards expected")
    check(alone_launches == (120 * forwards, 162 * forwards), f"unshared trunk launches {alone_launches}")
    bitwise = {}
    for member, single in zip(shared_members, alone_members):
        name = type(member).__name__
        for state in member._defaults:
            got, ref = member.metric_state[state], single.metric_state[state]
            same = torch.equal(torch.cat(got), torch.cat(ref)) if isinstance(got, list) else torch.equal(got, ref)
            check(same, f"{name} state {state}: shared trunk != its own trunk")
        np.random.seed(seed)
        value = member.compute()
        np.random.seed(seed)
        want = single.compute()
        value, want = (value if isinstance(value, tuple) else (value,)), (want if isinstance(want, tuple) else (want,))
        bitwise[name] = all(torch.equal(a, b) for a, b in zip(value, want))
        worst = max(_rel(a, float(b)) for a, b in zip(value, want))
        check(bitwise[name] or worst <= 1e-6, f"{name} shared {value} vs alone {want}")
    out["feature_share"] = {"images": 2 * n_img, "batch": img_batch, "forwards": forwards,
                            "shared_forwards": shared_forwards, "input_buffer_reused": True,
                            "launches_per_batch": [shared_launches[0] / forwards, shared_launches[1] / forwards],
                            "unshared_launches_per_batch": [alone_launches[0] / forwards, alone_launches[1] / forwards],
                            "images_per_s_shared": 2 * n_img / shared_s, "images_per_s_unshared": 2 * n_img / alone_s,
                            # the shared rate when every member and the trunk streamed eagerly, one forward a
                            # batch (NVIDIA H100 80GB HBM3, 700.00 W)
                            "images_per_s_shared_all_eager": 7178,
                            "values_bitwise_equal": bitwise}
    out["trunk_launches"] = {"matmul_bias_relu": int(ce.matmul_bias_relu.launches) - trunk0[0],
                             "bias_relu_": int(ce.bias_relu_.launches) - trunk0[1]}
    emit(out)
    return out


def clustering_nominal_wrappers(torch, np, ce, dev, gen, seed: int, smi: str, counters: dict, t_main: float, logits,
                                target, n_clusters: int = 50_000, classes: int = 1000) -> dict:
    """Phases 39-43; B3, B4 and B5 must not launch, B1 only in phase 43's confusion-matrix BootStrapper and B2a/B2b
    only in its trunk forwards."""
    t0 = time.perf_counter()
    for counter in counters.values():
        counter.launches.reset()
    seconds = {}
    preds_c, target_c = imagenet_clusters(torch, dev, gen, n_clusters, classes)
    with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = pool.submit(_host_extrinsic, preds_c.cpu().numpy(), target_c.cpu().numpy())
        t1 = time.perf_counter()
        phase_clustering_imagenet(torch, np, preds_c, target_c, pending, smi)
        seconds["clustering_imagenet"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_clustering_features(torch, dev, gen, preds_c, smi)
    seconds["clustering_features"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_nominal_adult(torch, np, dev, gen, smi)
    seconds["nominal_adult"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_fleiss_cifar10h(torch, np, dev, gen, smi)
    seconds["fleiss_cifar10h"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        wrappers = phase_wrappers_imagenet_cifar10(torch, np, ce, dev, gen, logits, target,
                                                   inception_npz(torch, np, seed, folder, dev, gen), smi, seed)
    seconds["wrappers_imagenet_cifar10"] = time.perf_counter() - t1
    launches = {name: int(counter.launches) for name, counter in counters.items()}
    expected = {name: 0 for name in counters}
    expected.update(wrappers["trunk_launches"])
    expected["confmat"] = wrappers["b1_launches"]
    check(launches == expected, f"clustering, nominal and the wrappers launched {launches}, expected {expected}")
    out = {"phase": "clustering_nominal_wrappers", "seconds": time.perf_counter() - t0, "phase_seconds": seconds,
           "seconds_since_start": time.perf_counter() - t_main, "kernel_launches": launches}
    emit(out)
    return out


# ------------------------------------------- audio, multimodal and segmentation (phases 44-47)
# SRMR against the float64 scipy oracle. The JAX package's float32 pipeline, which the port follows, lies up to
# 1.1% from that oracle on this generator's reverberant 8 s utterances at 16 kHz (0.19-1.11% over 16 scores drawn on
# the CPU, seeds 0-1, both `norm`s: `python tests/srmr_oracle_distance.py`), where the JAX suite's 5e-3 holds at
# 8 kHz on 1 s signals: float32 recurrences with poles within ~4e-4 of the unit circle, then a ratio of band
# energies; the card's draws lie up to 1.5% from it (an H100, seed 0)
SRMR_RTOL = 5e-2
# `fast=True` on the card against the port's CPU run of the same utterances: the FFT gammatonegram, then S1 at 400 Hz
# (measured 4.8e-7 on an H100). The default path's S1 is held to its plain loop bit for bit instead, on the card's
# own envelopes (phase 44's s1_main_shape line, which also gives how far cuFFT's envelopes lie from the CPU's)
SRMR_CPU_RTOL = 1e-5
S1_GAMMATONE_RTOL = 2e-4  # S1's gammatone cascade against float64 lfilter, of each channel's scale (6.5e-5 on the CPU)
S1_MOD_RTOL = 5e-3  # its modulation bands (1.8e-3 on the CPU): poles near the unit circle amplify float32 roundings
SNR_DB_ATOL = 1e-4  # the SNR family against float64 numpy: float32 sums of 32,000 products, then log10
SDR_DB_ATOL = 5e-2  # SDR's float32 Toeplitz solve against float64 Levinson (the JAX suite's tolerance)
CLIP_RTOL, CLIP_ATOL = 1e-4, 1e-4  # the card's float32 trunk against the port's CPU run (the JAX equivalence suite's)
DIST_RTOL = 1e-4  # distance transforms against scipy.ndimage
AREA_ATOL = 1e-6  # marching-cubes areas: float32 table entries against float64 numpy
REVERB = {"fs": 16_000, "utterances": 64, "samples": 128_000, "batch": 16}  # REVERB's 16 kHz evaluation, 8 s
WSJ0_2MIX = {"fs": 8_000, "mixtures": 3_000, "samples": 32_000, "batch": 100, "sdr_mixtures": 500}
CLIP_L14 = dict(vocab_size=49408, text_hidden=768, text_layers=12, text_heads=12, text_intermediate=3072,
                max_position=77, vision_hidden=1024, vision_layers=24, vision_heads=16, vision_intermediate=4096,
                image_size=224, patch_size=14, projection_dim=768, eos_token_id=2)  # openai/clip-vit-large-patch14
CLIP_B16 = dict(vocab_size=49408, text_hidden=512, text_layers=12, text_heads=8, text_intermediate=2048,
                max_position=77, vision_hidden=768, vision_layers=12, vision_heads=12, vision_intermediate=3072,
                image_size=224, patch_size=16, projection_dim=512, eos_token_id=2)  # openai/clip-vit-base-patch16
CLIP_BOS, CLIP_EOS = 49406, 49407  # CLIP's <|startoftext|> and <|endoftext|> (also its padding)
# phases 44-47's sizes, which audio_multimodal_segmentation hands each phase (a CPU rehearsal hands small ones).
# CLIPScore runs 2,500 of COCO Karpathy test's 5,000 pairs and CLIP-IQA 5,000 of KonIQ-10k's 10,073 images, for the
# script's time (188 pairs/s and 761 images/s in full float32 on an H100); the widths are not cut
AMS_SIZES = {
    "srmr_reverb": REVERB,
    "wsj0_2mix_separation": WSJ0_2MIX,
    "clipscore_coco_clipiqa_koniq": {"large": CLIP_L14, "base": CLIP_B16, "pairs": 2_500, "iqa_images": 5_000,
                                     "batch": 100, "iqa_batch": 64, "cpu_pairs": 32, "cpu_images": 16},
    "segmentation_brats_kits": {"volumes": 8, "slices": 64},
}


def reverb_utterances(torch, dev, gen, n: int, samples: int, fs: int):
    """Speech-like 16 kHz utterances made on the card, then reverberated: voiced harmonics (f0 100-250 Hz) and
    fricative noise under syllable envelopes (noise low-passed below ~16 Hz, rectified, with pauses), convolved
    with a room's exponentially decaying tail (T60 0.3-0.7 s), peak-normalised to 0.9."""
    t = torch.arange(samples, device=dev, dtype=torch.float32) / fs
    f0 = 100 + 150 * torch.rand(n, 1, generator=gen, device=dev)
    voiced = sum(torch.sin(2 * torch.pi * f0 * k * t + 6.28 * torch.rand(n, 1, generator=gen, device=dev)) / k
                 for k in range(1, 6))
    frames = samples // (fs // 100) + 2  # a syllable envelope sampled every 10 ms, interpolated to the samples
    env = torch.randn(n, 1, frames, generator=gen, device=dev)
    env = torch.nn.functional.avg_pool1d(env, 5, stride=1, padding=2)  # ~16 Hz and below
    env = torch.nn.functional.interpolate(env, size=samples, mode="linear", align_corners=False)[:, 0]
    voiced_env = torch.clamp(env, min=0)
    fricative_env = torch.clamp(-env - 0.5, min=0)
    dry = voiced * voiced_env + 2.0 * torch.randn(n, samples, generator=gen, device=dev) * fricative_env
    taps = fs // 2
    t60 = 0.3 + 0.4 * torch.rand(n, 1, generator=gen, device=dev)
    rir = torch.randn(n, taps, generator=gen, device=dev) * torch.exp(-6.9 * torch.arange(taps, device=dev) / fs / t60)
    rir[:, 0] = 1.0
    size = 1 << (samples + taps - 1).bit_length()
    wet = torch.fft.irfft(torch.fft.rfft(dry, size) * torch.fft.rfft(rir, size), size)[:, :samples]
    return (0.9 * wet / wet.abs().amax(dim=1, keepdim=True)).contiguous()


def _host_srmr(x, fs: int, norm: bool) -> list:
    """SRMR in float64 numpy/scipy (the slow path: ``lfilter`` for every IIR stage, ``hilbert`` for the envelope);
    a copy of the JAX suite's oracle, frame energies a channel at a time. Runs in a worker process."""
    from math import ceil, pi

    import numpy as np
    import scipy.signal as sig

    srmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    x = np.atleast_2d(np.asarray(x, np.float64))
    num_batch, time_len = x.shape
    x = x / np.maximum(np.abs(x).max(axis=-1, keepdims=True), 1.0)
    nums, den, gain = srmr._gammatone_coefs(fs, 23, 125.0)
    mfs = float(fs)
    w_length, w_inc = ceil(0.256 * mfs), ceil(0.064 * mfs)
    mod_num, mod_den, cutoffs = srmr._modulation_filterbank(4.0, 30.0 if norm else 128.0, 8, mfs, 2.0)
    pad = max(ceil(time_len / w_inc) * w_inc - time_len, w_length - time_len)
    num_frames = 1 + (time_len - w_length) // w_inc
    window = 0.54 - 0.46 * np.cos(2.0 * pi * np.arange(w_length) / (w_length + 1))
    energy = np.empty((num_batch, 23, 8, num_frames))
    for b in range(num_batch):
        gt = np.empty((23, time_len))
        for f in range(23):
            y = x[b]
            for s in range(4):
                y = sig.lfilter(nums[s, f], den[f], y)
            gt[f] = y / gain[f]
        env = np.abs(sig.hilbert(gt, axis=-1))  # time % 16 == 0: the padded-FFT envelope exactly
        for f in range(23):
            mod = np.stack([sig.lfilter(mod_num[k], mod_den[k], env[f]) for k in range(8)])
            frames = np.lib.stride_tricks.sliding_window_view(np.pad(mod, [(0, 0), (0, pad)]), w_length, axis=-1)
            energy[b, f] = ((frames[:, ::w_inc][:, :num_frames] * window) ** 2).sum(axis=-1)
    if norm:
        peak = energy.mean(axis=1, keepdims=True).max(axis=(2, 3), keepdims=True)
        energy = np.clip(energy, peak * 10.0 ** (-30.0 / 10.0), peak)
    erbs = np.flipud(srmr._erb_bandwidths(srmr._erb_centre_freqs(fs, 23, 125.0)))
    avg = energy.mean(axis=-1)
    scores = []
    for b in range(num_batch):
        ac_perc = avg[b].sum(axis=1) * 100.0 / avg[b].sum()
        bw = erbs[int(np.argmax(np.cumsum(ac_perc[::-1]) > 90.0))]
        kstar = 5 + sum(bw >= cutoffs[k] for k in (5, 6, 7))
        scores.append(float(avg[b, :, :4].sum() / avg[b, :, 4:kstar].sum()))
    return scores


def _s1_plain_on_host(x, b, a, gain, card, envelope=None) -> dict:
    """S1's plain loop on the CPU over the card's own input ``x`` (``biquad_bank_plain(x, b, a, gain)``), against
    the card's output ``card`` element by element; given ``envelope``, the card's Hilbert envelope of ``card``,
    also how far the CPU's envelope of the same ``card`` lies from it. Runs in a worker process, on one thread:
    the loop's steps are small."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    kb = importlib.import_module("torchmetrics_tpu_torch._kernels.biquad")
    t0 = time.perf_counter()
    plain = kb.biquad_bank_plain(*(None if v is None else torch.from_numpy(v) for v in (x, b, a, gain))).numpy()
    out = {"plain_cpu_seconds": time.perf_counter() - t0, "max_abs_err": float(np.abs(plain - card).max()),
           "unequal": int(np.count_nonzero(plain != card)), "elements": int(card.size)}
    if envelope is not None:
        srmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
        env_cpu = srmr._hilbert_envelope(torch.from_numpy(card)).numpy().reshape(envelope.shape)
        out["envelope_card_vs_cpu"] = {"max_abs": float(np.abs(envelope - env_cpu).max()),
                                       "max_rel_of_channel": _band_rel(np, envelope, env_cpu)}
    return out


def sm_clock_max_hz() -> float:
    """The card's highest SM clock, from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def _band_rel(np, got, want) -> float:
    """The largest error of any channel, relative to that channel's largest magnitude."""
    return float((np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max())


def phase_srmr_reverb(torch, np, kb, dev, gen, pool, smi: str, cfg: dict) -> dict:
    """SRMR at the reference's defaults over REVERB-shaped 8 s utterances: kernel S1 in both modes against its
    plain loop (at a cut length on the card; at the main path's shapes on the host, in two workers whose futures
    the phase returns as ``s1_on_host``) and float64 ``lfilter``; the scores against a float64 scipy oracle;
    utterances/s."""
    from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio as SRMR

    srmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    fs, n, samples, batch = cfg["fs"], cfg["utterances"], cfg["samples"], cfg["batch"]
    wave = reverb_utterances(torch, dev, gen, n, samples, fs)
    host4 = wave[:4].cpu().numpy()
    oracle = {norm: pool.submit(_host_srmr, host4, fs, norm) for norm in (False, True)}
    num, den, gain = srmr._gammatone_coefs(fs, 23, 125.0)
    mnum, mden, _ = srmr._modulation_filterbank(4.0, 128.0, 8, float(fs), 2.0)
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    g_args = (as32(num), as32(den), as32(gain))
    m_args = (as32(mnum / mden[:, :1])[None], as32(mden / mden[:, :1]), None)

    # S1 against its plain loop on the card, both modes, 2 utterances cut to 1 s, where the plain loop is timed
    # (it launches ~7 ops a step); bit for bit, as at the main path's shapes below
    cut = wave[:2, :fs].contiguous()
    g_kernel = kb.biquad_bank(cut, *g_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_plain = kb.biquad_bank_plain(cut, *g_args)
    torch.cuda.synchronize()
    g_plain_ms = (time.perf_counter() - t0) * 1e3
    env_cut = srmr._hilbert_envelope(g_kernel).reshape(-1, fs).contiguous()
    m_kernel = kb.biquad_bank(env_cut, *m_args[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_plain = kb.biquad_bank_plain(env_cut, *m_args[:2])
    torch.cuda.synchronize()
    m_plain_ms = (time.perf_counter() - t0) * 1e3
    vs_plain = max(rel_norm(torch, g_kernel, g_plain), rel_norm(torch, m_kernel, m_plain))
    max_abs_err = max(float((g_kernel - g_plain).abs().max()), float((m_kernel - m_plain).abs().max()))
    check(max_abs_err == 0, f"S1 against its plain loop on the card: max abs {max_abs_err}, relative {vs_plain}")
    cut_ms = {"gammatone": median_ms(torch, lambda: kb.biquad_bank(cut, *g_args), reps=10),
              "modulation": median_ms(torch, lambda: kb.biquad_bank(env_cut, *m_args[:2]), reps=10)}

    # S1 at full length against float64 lfilter: one utterance's 23 channels, then their envelopes' 8 bands
    import scipy.signal as sig

    g_full = kb.biquad_bank(wave[:1], *g_args)[0]
    x64 = wave[0].double().cpu().numpy()
    g_ref = np.empty((23, samples))
    for f in range(23):
        y = x64
        for s in range(4):
            y = sig.lfilter(num[s, f].astype(np.float32).astype(np.float64), den[f].astype(np.float32).astype(np.float64), y)
        g_ref[f] = y / np.float64(np.float32(gain[f]))
    env_full = srmr._hilbert_envelope(g_full[None])[0].contiguous()
    m_full = kb.biquad_bank(env_full, *m_args[:2])
    env64 = env_full.double().cpu().numpy()
    bm, am = m_args[0][0].double().numpy(), m_args[1].double().numpy()
    m_ref = np.stack([np.stack([sig.lfilter(bm[k], am[k], env64[f]) for k in range(8)]) for f in range(23)])
    g_err = _band_rel(np, g_full.double().cpu().numpy(), g_ref)
    m_err = _band_rel(np, m_full.double().cpu().numpy(), m_ref)
    check(g_err <= S1_GAMMATONE_RTOL and m_err <= S1_MOD_RTOL, f"S1 against float64 lfilter: {g_err}, {m_err}")

    # the card's first four utterances, held to the float64 oracle below (comparison launches, not counted)
    import warnings

    per_utt = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fast=True's experimental-path warning
        for name in ("default", "norm", "fast"):
            per_utt[name] = srmr.speech_reverberation_modulation_energy_ratio(
                wave[:4], fs, norm=name == "norm", fast=name == "fast").cpu().numpy()

    # the main path: three metrics over the 64 utterances in batches of 16; S1 twice an update (once on `fast`)
    metrics = {"default": SRMR(fs), "norm": SRMR(fs, norm=True), "fast": SRMR(fs, fast=True)}
    rates = {}
    updates = n // batch
    kb.biquad_bank.launches.reset()
    for name, metric in metrics.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for lo in range(0, n, batch):
                metric.update(wave[lo:lo + batch])
            value = float(metric.compute())
            torch.cuda.synchronize()
        rates[name] = {"utterances_per_s": n / (time.perf_counter() - t0), "srmr_mean": value}
        check(int(metric.total) == n and np.isfinite(value), f"SRMR {name}: {value} over {int(metric.total)}")
    main_launches = int(kb.biquad_bank.launches)
    check(main_launches == 5 * updates, f"S1 launched {main_launches} times on the main path, expected {5 * updates}")

    # S1 against its plain loop at the main path's shapes: its first update's 16 utterances through the 23
    # gammatone channels, then their envelopes through the 8 bands (comparison launches, not counted). The plain
    # loop runs on the host, in two workers, while phases 45-47 run; the result must equal it bit for bit
    xb = wave[:batch].contiguous()
    g_b = kb.biquad_bank(xb, *g_args)
    env_b = srmr._hilbert_envelope(g_b).reshape(-1, samples).contiguous()
    host = lambda t: None if t is None else t.cpu().numpy()  # noqa: E731
    s1_on_host = {
        "gammatone": pool.submit(_s1_plain_on_host, host(xb), *map(host, g_args), host(g_b), host(env_b)),
        "modulation": pool.submit(_s1_plain_on_host, host(env_b), *map(host, m_args),
                                  host(kb.biquad_bank(env_b, *m_args[:2]))),
    }
    del g_b

    errs = {}
    t0 = time.perf_counter()
    for norm in (False, True):
        want = np.asarray(oracle[norm].result())
        got = per_utt["norm" if norm else "default"]
        errs["norm" if norm else "default"] = float(np.abs(got / want - 1).max())
    oracle_wait_s = time.perf_counter() - t0
    check(max(errs.values()) <= SRMR_RTOL, f"SRMR against the float64 oracle: {errs}")
    fast_cpu = srmr.speech_reverberation_modulation_energy_ratio(wave[:4].cpu(), fs, fast=True).numpy()
    errs["fast_vs_cpu"] = float(np.abs(per_utt["fast"] / fast_cpu - 1).max())
    check(errs["fast_vs_cpu"] <= SRMR_CPU_RTOL, f"SRMR fast on the card against its CPU run: {errs['fast_vs_cpu']}")

    # S1's time at the main path's shapes (one update: 16 x 23 channels, then 16 x 23 x 8 bands, 128,000 samples)
    main_ms = {"gammatone": median_ms(torch, lambda: kb.biquad_bank(xb, *g_args), reps=5),
               "modulation": median_ms(torch, lambda: kb.biquad_bank(env_b, *m_args[:2]), reps=5)}
    cost_main = [kb.biquad_bank_cost(batch, 23, samples, 4), kb.biquad_bank_cost(batch * 23, 8, samples, 1)]
    cost_cut = [kb.biquad_bank_cost(2, 23, fs, 4), kb.biquad_bank_cost(2 * 23, 8, fs, 1)]
    bounds_main = [bound_ms(c, F32_FLOPS_PER_S) for c in cost_main]
    bounds_cut = [bound_ms(c, F32_FLOPS_PER_S) for c in cost_cut]
    # the serial chain a channel walks: T samples x S sections x ~4 dependent float32 operations of ~4 cycles
    clock_hz = sm_clock_max_hz()
    chain_main_ms = sum(samples * s * 4 * 4 / clock_hz * 1e3 for s in (4, 1))
    out = {
        "phase": "srmr_reverb", "fs": fs, "utterances": n, "samples": samples, "batch": batch, "rates": rates,
        "s1_vs_plain_rel": vs_plain, "s1_vs_plain_max_abs": max_abs_err,
        "s1_vs_float64": {"gammatone": g_err, "modulation": m_err, "rtol": [S1_GAMMATONE_RTOL, S1_MOD_RTOL]},
        "srmr_rel_err": errs, "srmr_rtol": {"oracle": SRMR_RTOL, "cpu": SRMR_CPU_RTOL},
        "oracle_wait_seconds": oracle_wait_s, "plain_loop_seconds": (g_plain_ms + m_plain_ms) / 1e3,
        "srmr_oracle": {"default": oracle[False].result(), "norm": oracle[True].result()},
        "s1_main_path_launches": main_launches,
        "s1_ms": {"main": main_ms, "cut": cut_ms}, "s1_plain_ms_cut": {"gammatone": g_plain_ms, "modulation": m_plain_ms},
        "s1_bound_ms": {"main": [b for b, _ in bounds_main], "cut": [b for b, _ in bounds_cut]},
        "s1_chain_estimate_ms_main": chain_main_ms, "sm_clock_max_hz": clock_hz, "card": smi,
    }
    emit(out)
    out["s1_on_host"] = s1_on_host
    out["kernel_entry"] = {
        "ms": sum(cut_ms.values()), "plain_ms": g_plain_ms + m_plain_ms,
        "bound_ms": sum(b for b, _ in bounds_cut), "bound_by": "bytes" if all(k == "bytes" for _, k in bounds_cut)
        else "operations", "max_abs_err": max_abs_err, "launches": main_launches,
        "ms_main_path": sum(main_ms.values()), "bound_ms_main_path": sum(b for b, _ in bounds_main),
        "chain_estimate_ms_main_path": chain_main_ms,
    }
    return out


def separation_sources(torch, dev, gen, n: int, spk: int, samples: int, fs: int):
    """``(n, spk, samples)`` speech-like sources (WSJ0-2mix's utterances padded with zeros to the longest) and
    estimates: each source plus noise at 5-15 dB, the speakers in a random order per mixture."""
    t = torch.arange(samples, device=dev, dtype=torch.float32) / fs
    f0 = 90 + 160 * torch.rand(n, spk, 1, generator=gen, device=dev)
    src = sum(torch.sin(2 * torch.pi * f0 * k * t) / k for k in range(1, 4))
    src = src * torch.clamp(torch.sin(2 * torch.pi * (3 + 3 * torch.rand(n, spk, 1, generator=gen, device=dev)) * t),
                            min=0) + 0.05 * torch.randn(n, spk, samples, generator=gen, device=dev)
    length = (samples * (0.4 + 0.6 * torch.rand(n, spk, 1, generator=gen, device=dev))).long()
    src = src * (torch.arange(samples, device=dev) < length)
    snr_db = 5 + 10 * torch.rand(n, spk, 1, generator=gen, device=dev)
    noise = torch.randn(n, spk, samples, generator=gen, device=dev)
    noise = noise * src.norm(dim=-1, keepdim=True) / noise.norm(dim=-1, keepdim=True) / 10 ** (snr_db / 20)
    perm = torch.argsort(torch.rand(n, spk, generator=gen, device=dev), dim=1)
    est = torch.gather(src + noise, 1, perm[:, :, None].expand(-1, -1, samples))
    return est.contiguous(), src.contiguous()


def _snr64(np, p, t, kind: str):
    """The SNR family in float64 numpy, as the reference defines it."""
    eps = np.finfo(np.float32).eps
    if kind in ("si_snr", "c_si_snr"):
        p, t = p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    if kind == "snr":
        return 10 * np.log10(((t**2).sum(-1) + eps) / (((t - p) ** 2).sum(-1) + eps))
    axes = (-2, -1) if kind == "sa_sdr" else -1
    alpha = ((p * t).sum(axes, keepdims=True) + eps) / ((t**2).sum(axes, keepdims=True) + eps)
    ts = alpha * t
    return 10 * np.log10(((ts**2).sum(axes) + eps) / (((ts - p) ** 2).sum(axes) + eps))


def _sums_to_db(np, pt, tt, pp, zero_scale: bool):
    """10 log10 of the SNR family's ratio from float64 inner products: ``alpha = (pt + eps) / (tt + eps)`` (scale
    invariant) or 1, target energy ``alpha^2 tt`` over noise energy ``alpha^2 tt - 2 alpha pt + pp``."""
    eps = np.finfo(np.float32).eps
    alpha = np.ones_like(pt) if zero_scale else (pt + eps) / (tt + eps)
    return 10 * np.log10((alpha**2 * tt + eps) / (alpha**2 * tt - 2 * alpha * pt + pp + eps))


def _host_separation(est, src, chunk: int = 250) -> dict:
    """Float64 numpy references of the 2-speaker stream, from each pair's float64 inner products: the exhaustive
    best permutation by SI-SNR and its value, SNR and SI-SDR of each estimate against its source, SA-SDR of each
    mixture. Runs in the main process: handing 1.5 GB to a worker cost ~20 s of waiting on an H100's host."""
    import numpy as np

    perms = np.asarray([[0, 1], [1, 0]])
    out = {"perm": [], "best": [], "snr": [], "si_sdr": [], "sa_sdr": []}
    for lo in range(0, len(est), chunk):
        p, t = est[lo:lo + chunk].astype(np.float64), src[lo:lo + chunk].astype(np.float64)
        n = p.shape[-1]
        pt = np.einsum("bjs,bis->bij", p, t)  # [b, target i, estimate j]
        tt, pp = np.einsum("bis,bis->bi", t, t), np.einsum("bjs,bjs->bj", p, p)
        sp, st = p.sum(-1), t.sum(-1)
        pt_c = pt - st[:, :, None] * sp[:, None, :] / n  # zero-mean (SI-SNR) sums
        tt_c, pp_c = tt - st**2 / n, pp - sp**2 / n
        pair = _sums_to_db(np, pt_c, tt_c[:, :, None], pp_c[:, None, :], False)  # [b, i, j]
        scores = np.stack([pair[:, [0, 1], q].mean(-1) for q in perms], 1)  # mean over i of metric(p[q[i]], t[i])
        best = perms[scores.argmax(1)]
        rows = np.arange(len(p))[:, None]
        pt_al = pt[rows, [[0, 1]], best]  # [b, i]: estimate best[i] against source i
        pp_al = pp[rows, best]
        out["perm"].append(best)
        out["best"].append(scores.max(1))
        out["snr"].append(_sums_to_db(np, pt_al, tt, pp_al, True))
        out["si_sdr"].append(_sums_to_db(np, pt_al, tt, pp_al, False))
        out["sa_sdr"].append(_sums_to_db(np, pt_al.sum(1), tt.sum(1), pp_al.sum(1), False))
    return {k: np.concatenate(v) for k, v in out.items()}


def _sdr64(np, p, t, taps: int = 512):
    """SDR with a ``taps``-tap distortion filter in float64: the same normalisation, Levinson's Toeplitz solve."""
    import scipy.fft as sfft
    from scipy.linalg import solve_toeplitz

    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-6)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-6)
    n_fft = 1 << (2 * t.shape[-1] - 2).bit_length()
    workers = os.cpu_count() or 1
    tf, pf = sfft.rfft(t, n_fft, workers=workers), sfft.rfft(p, n_fft, workers=workers)
    r0 = sfft.irfft(np.abs(tf) ** 2, n_fft, workers=workers)[:, :taps]
    b = sfft.irfft(np.conj(tf) * pf, n_fft, workers=workers)[:, :taps]
    r0[:, 0] += 1e-7  # the port's diagonal load
    coh = np.asarray([b[i] @ solve_toeplitz(r0[i], b[i]) for i in range(len(b))])
    return 10 * np.log10(coh / (1 - coh))


def phase_wsj0_2mix_separation(torch, np, dev, gen, smi: str, cfg: dict) -> dict:
    """WSJ0-2mix test's shape through PIT (both modes), the SNR family, C-SI-SNR on a 512-point STFT and SDR,
    against float64 numpy and an exhaustive float64 permutation search; 3 and 8 speakers against scipy."""
    from scipy.optimize import linear_sum_assignment

    import torchmetrics_tpu_torch.audio as A
    import torchmetrics_tpu_torch.functional.audio as FA

    n, samples, batch, fs = cfg["mixtures"], cfg["samples"], cfg["batch"], cfg["fs"]
    est, src = separation_sources(torch, dev, gen, n, 2, samples, fs)
    host_s = {}  # the host seconds of the float64 references, by step: where the phase's wall time goes
    window = torch.hann_window(512, device=dev)

    def stft(x):
        spec = torch.stft(x.reshape(-1, x.shape[-1]), 512, 128, window=window, return_complex=True)
        return spec.reshape(*x.shape[:-1], *spec.shape[-2:])

    perm = torch.cat([FA.permutation_invariant_training(est[lo:lo + batch], src[lo:lo + batch],
                                                        FA.scale_invariant_signal_noise_ratio)[1]
                      for lo in range(0, n, batch)])
    aligned = FA.pit_permutate(est, perm)  # each estimate beside its source
    metrics = {
        "pit_speaker_wise": A.PermutationInvariantTraining(FA.scale_invariant_signal_noise_ratio),
        "pit_permutation_wise": A.PermutationInvariantTraining(FA.scale_invariant_signal_noise_ratio,
                                                               mode="permutation-wise"),
        "snr": A.SignalNoiseRatio(), "si_sdr": A.ScaleInvariantSignalDistortionRatio(),
        "sa_sdr": A.SourceAggregatedSignalDistortionRatio(), "c_si_snr": A.ComplexScaleInvariantSignalNoiseRatio(),
    }
    rates = {}
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            p, t = (est if name.startswith("pit") else aligned)[lo:lo + batch], src[lo:lo + batch]
            if name == "c_si_snr":
                p, t = stft(p), stft(t)
            metric.update(p, t)
        value = float(metric.compute())
        torch.cuda.synchronize()
        rates[name] = {"mixtures_per_s": n / (time.perf_counter() - t0), "value_db": value}

    # SDR, 512 taps, on the first 500 mixtures (1,000 signals), against a float64 Levinson solve
    m = cfg["sdr_mixtures"]
    sdr = A.SignalDistortionRatio()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, m, batch):
        sdr.update(aligned[lo:lo + batch], src[lo:lo + batch])
    sdr_value = float(sdr.compute())
    torch.cuda.synchronize()
    rates["sdr_512"] = {"mixtures_per_s": m / (time.perf_counter() - t0), "value_db": sdr_value}
    sdr_got = FA.signal_distortion_ratio(aligned[:m], src[:m]).reshape(-1).double().cpu().numpy()
    t0 = time.perf_counter()
    sdr_want = _sdr64(np, aligned[:m].reshape(-1, samples).double().cpu().numpy(),
                      src[:m].reshape(-1, samples).double().cpu().numpy())
    host_s["sdr_float64"] = time.perf_counter() - t0
    errs = {"sdr_per_signal": float(np.abs(sdr_got - sdr_want).max())}
    check(errs["sdr_per_signal"] <= SDR_DB_ATOL, f"SDR against float64: {errs['sdr_per_signal']} dB")

    # C-SI-SNR per signal on the first batch, against float64 numpy on the same spectra
    ps, ts = stft(aligned[:batch]), stft(src[:batch])
    c_want = _snr64(np, torch.view_as_real(ps).double().cpu().numpy().reshape(batch, 2, -1),
                    torch.view_as_real(ts).double().cpu().numpy().reshape(batch, 2, -1), "c_si_snr")
    c_got = FA.complex_scale_invariant_signal_noise_ratio(ps, ts).double().cpu().numpy()
    errs["c_si_snr_per_signal"] = float(np.abs(c_got - c_want).max())

    # the stream against the float64 references
    t0 = time.perf_counter()
    ref = _host_separation(est.cpu().numpy(), src.cpu().numpy())
    host_s["stream_float64"] = time.perf_counter() - t0
    check(np.array_equal(perm.cpu().numpy(), ref["perm"]), "PIT permutations != the exhaustive float64 search")
    per_signal = {"snr": FA.signal_noise_ratio(aligned, src), "si_sdr": FA.scale_invariant_signal_distortion_ratio(
        aligned, src), "sa_sdr": FA.source_aggregated_signal_distortion_ratio(aligned, src),
        "best": FA.permutation_invariant_training(est, src, FA.scale_invariant_signal_noise_ratio)[0]}
    for name, got in per_signal.items():
        errs[f"{name}_per_signal"] = float(np.abs(got.double().cpu().numpy() - ref[name]).max())
    for name, key in (("pit_speaker_wise", "best"), ("pit_permutation_wise", "best"), ("snr", "snr"),
                      ("si_sdr", "si_sdr"), ("sa_sdr", "sa_sdr")):
        errs[name] = abs(rates[name]["value_db"] - float(ref[key].mean()))
    check(max(errs[k] for k in errs if k != "sdr_per_signal") <= SNR_DB_ATOL,
          f"SNR family against float64 numpy: {errs}")

    # 3 speakers (WSJ0-3mix's shape; exhaustive) and 8 (the Hungarian route) against scipy on float64 matrices
    spk_checks = {}
    t0 = time.perf_counter()
    for spk, count, length in ((3, 100, samples), (8, 20, 8000)):
        e, s = separation_sources(torch, dev, gen, count, spk, length, fs)
        vals, got_perm = FA.permutation_invariant_training(e, s, FA.scale_invariant_signal_noise_ratio)
        e64, s64 = e.double().cpu().numpy(), s.double().cpu().numpy()
        mtx = np.stack([np.stack([_snr64(np, e64[:, j], s64[:, i], "si_snr") for j in range(spk)], 1)
                        for i in range(spk)], 1)  # [count, target, pred]
        lsa = np.stack([linear_sum_assignment(mtx[b], maximize=True)[1] for b in range(count)])
        check(np.array_equal(got_perm.cpu().numpy(), lsa), f"PIT at {spk} speakers != linear_sum_assignment")
        best = np.take_along_axis(mtx, lsa[:, :, None], 2)[..., 0].mean(1)
        spk_checks[spk] = float(np.abs(vals.double().cpu().numpy() - best).max())
        check(spk_checks[spk] <= SNR_DB_ATOL, f"PIT values at {spk} speakers: {spk_checks[spk]} dB")
    host_s["speakers_3_and_8"] = time.perf_counter() - t0
    out = {"phase": "wsj0_2mix_separation", "mixtures": n, "speakers": 2, "fs": fs, "samples": samples,
           "batch": batch, "sdr_mixtures": m, "rates": rates, "host_seconds": host_s, "max_err_db": errs,
           "pit_spk_max_err_db": spk_checks,
           "tolerance_db": {"snr_family": SNR_DB_ATOL, "sdr": SDR_DB_ATOL}, "card": smi}
    emit(out)
    return out


class ClipTokenizer:
    """Captions to CLIP-shaped ids: BOS, one id a lower-cased word (a stable hash below the specials), EOS, padded
    with EOS to 77 as the OpenAI checkpoints' tokenizer pads; cut to 77 with EOS kept."""

    def __call__(self, texts):
        import numpy as np

        ids = np.full((len(texts), 77), CLIP_EOS, dtype=np.int64)
        mask = np.zeros((len(texts), 77), dtype=np.int64)
        for i, text in enumerate(texts):
            words = [sum((j + 1) * ord(ch) for j, ch in enumerate(w)) % 49_000 + 256 for w in text.lower().split()]
            row = [CLIP_BOS, *words[:75], CLIP_EOS]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def coco_captions(np, rng, n: int) -> list:
    """COCO-caption-shaped sentences: 6-75 words (8-77 tokens with BOS and EOS), mean ~11 words."""
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9))) for _ in range(5000)]
    lengths = np.clip(np.rint(rng.gamma(5.0, 11.0 / 5.0, n)), 6, 75).astype(int)
    lengths[: n // 100] = 75  # a few at the full width
    return [" ".join(vocab[j] for j in rng.integers(0, len(vocab), k)) for k in lengths]


def natural_images(torch, dev, gen, n: int, h: int, w: int):
    """uint8 ``(n, 3, h, w)`` images with structure at several scales (smooth fields plus texture), made on the card."""
    coarse = torch.rand(n, 3, 6, 8, generator=gen, device=dev)
    mid = torch.rand(n, 3, 48, 64, generator=gen, device=dev)
    img = (0.7 * torch.nn.functional.interpolate(coarse, (h, w), mode="bilinear", align_corners=False)
           + 0.25 * torch.nn.functional.interpolate(mid, (h, w), mode="bilinear", align_corners=False)
           + 0.05 * torch.rand(n, 3, h, w, generator=gen, device=dev))
    return (img.clamp(0, 1) * 255).to(torch.uint8)


def clip_npz(torch, np, cfg: dict, seed: int, folder: str, dev) -> str:
    """Seeded random CLIP weights at ``cfg``'s widths (``init_clip_weights_``, drawn on the card), written through
    ``clip_variables_from_state_dict`` as the JAX package's flat ``.npz``."""
    from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipConfig, _ClipModel, init_clip_weights_
    from torchmetrics_tpu_torch.utilities.convert import clip_variables_from_state_dict

    config = ClipConfig(**cfg)
    with torch.device("meta"):
        net = _ClipModel(config)
    net = init_clip_weights_(net.to_empty(device=dev), seed)
    path = os.path.join(folder, f"clip_{cfg['vision_hidden']}_{cfg['patch_size']}.npz")
    np.savez(path, **clip_variables_from_state_dict(net.state_dict(), config))
    return path


def _cpu_clip(npz_l: str, npz_b: str, imgs_l, captions: list, imgs_b, threads: int = 6) -> dict:
    """The port's CPU run of the first pairs' CLIPScores and the first images' CLIP-IQA probabilities, in a worker."""
    import torch

    torch.set_num_threads(threads)
    from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import (
        _clip_iqa_compute, _clip_iqa_format_prompts, _clip_iqa_get_anchor_vectors, _clip_iqa_update)
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update
    from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipExtractor

    large = ClipExtractor(npz_l, tokenizer=ClipTokenizer(), device="cpu")
    scores, _ = _clip_score_update(torch.from_numpy(imgs_l), captions, large)
    del large
    base = ClipExtractor(npz_b, tokenizer=ClipTokenizer(), device="cpu")
    prompts, names = _clip_iqa_format_prompts(tuple(CLIP_IQA_PROMPTS))
    anchors = _clip_iqa_get_anchor_vectors(base, prompts)
    probs = _clip_iqa_compute(_clip_iqa_update(torch.from_numpy(imgs_b), base, 255.0), anchors, names,
                              format_as_dict=False)
    return {"scores": scores.numpy(), "probs": probs.numpy()}


CLIP_IQA_PROMPTS = ("quality", "brightness", "noisiness", "colorfullness", "sharpness", "contrast", "complexity",
                    "natural", "happy", "scary", "new", "warm", "real", "beautiful", "lonely", "relaxing")


def phase_clipscore_coco_clipiqa_koniq(torch, np, dev, gen, seed: int, smi: str, pool, cfg: dict) -> dict:
    """CLIPScore on ViT-L/14 widths over COCO Karpathy test's pairs, CLIP-IQA on ViT-B/16 widths over KonIQ-10k's
    images with all 16 prompts; the first pairs (through the metric's update and compute too) and images against
    the port's CPU run."""
    from torchmetrics_tpu_torch.functional.multimodal import clip_score
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update
    from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore

    n_pairs, n_iqa, batch, iqa_batch = cfg["pairs"], cfg["iqa_images"], cfg["batch"], cfg["iqa_batch"]
    n_cpu, n_cpu_b = cfg["cpu_pairs"], cfg["cpu_images"]
    rng = np.random.default_rng([seed, 46])
    captions = coco_captions(np, rng, n_pairs)
    folder = tempfile.mkdtemp(prefix="clip_")  # removed below, after the CPU run has read the weights
    t0 = time.perf_counter()
    npz_l = clip_npz(torch, np, cfg["large"], seed, folder, dev)
    npz_b = clip_npz(torch, np, cfg["base"], seed + 1, folder, dev)
    weights_s = time.perf_counter() - t0
    # CLIPScore's images as floats in [0, 1]: both packages cast them to float32 before the encoder, so a uint8
    # image would reach CLIP's normalisation unscaled; CLIP-IQA scales by its data_range (255 here)
    first_l = natural_images(torch, dev, gen, n_cpu, 480, 640).float() / 255
    first_b = natural_images(torch, dev, gen, n_cpu_b, 768, 1024)
    cpu = pool.submit(_cpu_clip, npz_l, npz_b, first_l.cpu().numpy(), captions[:n_cpu], first_b.cpu().numpy())

    t0 = time.perf_counter()
    metric = CLIPScore(weights_path=npz_l, tokenizer=ClipTokenizer())
    load_s = time.perf_counter() - t0
    model = metric.model
    got_scores, _ = _clip_score_update(first_l, captions[:n_cpu], model)
    # the same pairs through the metric's own state: its sum is the per-pair scores' sum, its compute their mean
    # clamped at 0 (random towers give cosines around 0, so the clamp may bite); held to the CPU run below
    metric.update(first_l, captions[:n_cpu])
    first_state = {"score": float(metric.score), "n_samples": int(metric.n_samples),
                   "compute": float(metric.compute()), "per_pair_sum": float(got_scores.sum())}
    check(first_state["n_samples"] == n_cpu and first_state["score"] == first_state["per_pair_sum"]
          and first_state["compute"] == max(float(np.float32(first_state["score"]) / np.float32(n_cpu)), 0.0),
          f"CLIPScore's state: {first_state}")
    metric.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_pairs, batch):
        metric.update(natural_images(torch, dev, gen, min(batch, n_pairs - lo), 480, 640).float() / 255,
                      captions[lo:lo + batch])
    clip_value = float(metric.compute())
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    unclamped = float(metric.score / metric.n_samples)
    check(int(metric.n_samples) == n_pairs and clip_value == max(unclamped, 0.0),
          f"CLIPScore over the stream: {clip_value}, {unclamped} over {int(metric.n_samples)}")
    probe = natural_images(torch, dev, gen, batch, 480, 640).float() / 255
    update_ms = wall_ms(torch, lambda: metric.update(probe, captions[:batch]), reps=3, warmup=1)
    trunk_ms = wall_ms(torch, lambda: (model.get_image_features(probe), model.get_text_features(captions[:batch])),
                       reps=3, warmup=1)
    # ViT-L/14's trunk graphs (batch 100 images, 100 x 77 tokens) and the metric's own, with their pools
    pool_bytes = importlib.import_module("torchmetrics_tpu_torch._compile").pool_bytes
    l14_graphs = {"trunk_graphs": len(model.captured.graphs), "trunk_pool_bytes": pool_bytes(model.captured.pool),
                  "metric_graphs": len(metric.__dict__.get("_auto_update_fn", {})),
                  "metric_pool_bytes": pool_bytes(metric.__dict__.get("_graph_pool"))}
    del metric, model

    iqa = CLIPImageQualityAssessment(prompts=CLIP_IQA_PROMPTS, weights_path=npz_b, tokenizer=ClipTokenizer(),
                                     data_range=255.0)
    iqa.update(first_b)
    got_probs = torch.stack([v for v in iqa.compute().values()], 1)
    iqa.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_iqa, iqa_batch):
        iqa.update(natural_images(torch, dev, gen, min(iqa_batch, n_iqa - lo), 768, 1024))
    probs = iqa.compute()
    torch.cuda.synchronize()
    iqa_s = time.perf_counter() - t0
    check(all(v.shape == (n_iqa,) and bool(torch.isfinite(v).all()) for v in probs.values()), "CLIP-IQA output")
    probe_b = natural_images(torch, dev, gen, iqa_batch, 768, 1024)
    iqa_update_ms = wall_ms(torch, lambda: iqa.update(probe_b), reps=3, warmup=1)
    iqa_trunk_ms = wall_ms(torch, lambda: iqa.model.get_image_features(probe_b.float() / 255.0), reps=3, warmup=1)
    del iqa

    # the default random-projection encoder on the card against its CPU run, pair by pair (the mean may clamp to 0)
    from torchmetrics_tpu_torch.functional.multimodal._encoder import RandomProjectionClipEncoder

    rp_gpu, _ = _clip_score_update(first_l, captions[:n_cpu], RandomProjectionClipEncoder(warn=False))
    rp_cpu, _ = _clip_score_update(first_l.cpu(), captions[:n_cpu],
                                   RandomProjectionClipEncoder(warn=False, device="cpu"))
    rp_err = float((rp_gpu.cpu() - rp_cpu).abs().max() / rp_cpu.abs().max())
    check(rp_err <= 1e-5, f"random-projection CLIPScore on the card against its CPU run: {rp_err}")
    check(bool(torch.isfinite(clip_score(first_l, captions[:n_cpu], model=RandomProjectionClipEncoder(
        warn=False)))), "random-projection clip_score")

    t0 = time.perf_counter()
    ref = cpu.result()
    cpu_wait_s = time.perf_counter() - t0
    score_err = float(np.abs(got_scores.cpu().numpy() - ref["scores"]).max())
    prob_err = float(np.abs(got_probs.cpu().numpy() - ref["probs"]).max())
    check(np.allclose(got_scores.cpu().numpy(), ref["scores"], rtol=CLIP_RTOL, atol=CLIP_ATOL),
          f"CLIPScore per pair against the CPU run: {score_err}")
    cpu_mean = float(ref["scores"].astype(np.float64).mean())  # a mean errs no more than its worst pair
    state_err = abs(first_state["score"] / n_cpu - cpu_mean)
    check(np.isclose(first_state["score"] / n_cpu, cpu_mean, rtol=CLIP_RTOL, atol=CLIP_ATOL),
          f"CLIPScore's state over the first pairs against the CPU run's mean: {state_err}")
    check(np.allclose(got_probs.cpu().numpy(), ref["probs"], rtol=CLIP_RTOL, atol=CLIP_ATOL),
          f"CLIP-IQA against the CPU run: {prob_err}")
    shutil.rmtree(folder, ignore_errors=True)
    out = {
        "phase": "clipscore_coco_clipiqa_koniq", "pairs": n_pairs, "iqa_images": n_iqa,
        "cut": {"pairs": [5000, n_pairs], "iqa_images": [10_073, n_iqa]}, "batch": batch,
        "iqa_batch": iqa_batch, "prompts": len(CLIP_IQA_PROMPTS), "weights_seconds": weights_s,
        "load_seconds_l14": load_s, "cpu_run_wait_seconds": cpu_wait_s,
        "clipscore": {"value": clip_value, "unclamped_mean": unclamped, "pairs_per_s": n_pairs / clip_s, "update_ms": update_ms,
                      "trunk_ms": trunk_ms, "trunk_share": trunk_ms / update_ms, "vit_l14_graphs": l14_graphs},
        "clip_iqa": {"images_per_s": n_iqa / iqa_s, "update_ms": iqa_update_ms, "trunk_ms": iqa_trunk_ms,
                     "trunk_share": iqa_trunk_ms / iqa_update_ms,
                     "quality_mean": float(probs["quality"].mean())},
        "vs_cpu": {"score_max_abs": score_err, "prob_max_abs": prob_err, "pairs": n_cpu, "images": n_cpu_b,
                   "state_mean_abs": state_err, "first_state": first_state, "cpu_mean": cpu_mean,
                   "random_projection_rel": rp_err},
        "card": smi,
    }
    emit(out)
    return out


def brats_volumes(torch, dev, gen, n: int, shape=(240, 240, 155)):
    """BraTS-shaped pairs of whole-tumour masks: a smooth blob (~1-3% of the volume) and a perturbed copy."""
    small = torch.rand(n, 1, shape[0] // 8, shape[1] // 8, shape[2] // 5 + 1, generator=gen, device=dev)
    field = torch.nn.functional.interpolate(small, size=shape, mode="trilinear", align_corners=False)[:, 0]
    grids = torch.meshgrid(*[torch.linspace(-1, 1, s, device=dev) for s in shape], indexing="ij")
    center = 1.0 - sum(g**2 for g in grids)
    target = (field + center) > 1.6
    noise = torch.rand(n, 1, shape[0] // 8, shape[1] // 8, shape[2] // 5 + 1, generator=gen, device=dev)
    noise = torch.nn.functional.interpolate(noise, size=shape, mode="trilinear", align_corners=False)[:, 0]
    preds = (field + center + 0.1 * (noise - 0.5)) > 1.6
    return preds, target


def kits_slices(torch, dev, gen, n: int, side: int = 512):
    """KiTS19-shaped axial slices: kidney (~2-4% of the slice) as two smooth blobs; predictions a perturbed copy."""
    small = torch.rand(n, 1, side // 32, side // 32, generator=gen, device=dev)
    field = torch.nn.functional.interpolate(small, size=(side, side), mode="bicubic", align_corners=False)[:, 0]
    y, x = torch.meshgrid(torch.linspace(-1, 1, side, device=dev), torch.linspace(-1, 1, side, device=dev),
                          indexing="ij")
    kidneys = torch.maximum(-((x - 0.4) ** 2 + y**2) * 8, -((x + 0.4) ** 2 + y**2) * 8) + 1
    target = (kidneys + 0.3 * field) > 1.05
    noise = torch.nn.functional.interpolate(torch.rand(n, 1, side // 16, side // 16, generator=gen, device=dev),
                                            size=(side, side), mode="bilinear", align_corners=False)[:, 0]
    preds = (kidneys + 0.3 * field + 0.15 * (noise - 0.5)) > 1.05
    return preds, target


def _codes64(np, vol):
    """2x2x2 neighbour codes of a padded boolean volume in numpy, bits weighted 128 .. 1."""
    v = np.pad(vol, 1).astype(np.int64)
    return sum(v[i:v.shape[0] - 1 + i, j:v.shape[1] - 1 + j, k:v.shape[2] - 1 + k] << (7 - (4 * i + 2 * j + k))
               for i in (0, 1) for j in (0, 1) for k in (0, 1))


def _host_distances(masks, edges_t, edges_p) -> dict:
    """scipy.ndimage's distance transforms of each slice (edt, cdt chessboard and taxicab) and the surface distances
    of its prediction edges to its target edges; run in a worker process."""
    import numpy as np
    from scipy import ndimage

    out = {"euclidean": [], "chessboard": [], "taxicab": [], "surface": []}
    for m, et, ep in zip(masks, edges_t, edges_p):
        out["euclidean"].append(ndimage.distance_transform_edt(m).astype(np.float32))
        for metric in ("chessboard", "taxicab"):
            out[metric].append(ndimage.distance_transform_cdt(m, metric=metric).astype(np.float32))
        out["surface"].append(ndimage.distance_transform_edt(~et)[ep].astype(np.float32))
    return out


def phase_segmentation_brats_kits(torch, np, dev, gen, smi: str, pool, cfg: dict) -> dict:
    """mask_edges with spacing on BraTS-shaped volumes (codes exact, areas 1e-6 against numpy); surface_distance
    and distance_transform (three metrics) on KiTS19-shaped slices against scipy.ndimage; tile sizes, peak memory."""
    import torchmetrics_tpu_torch.functional.segmentation as S

    seg = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.utils")
    volumes, slices = cfg["volumes"], cfg["slices"]
    preds, target = brats_volumes(torch, dev, gen, volumes)
    table, _ = seg._table_surface_area((1, 1, 1))
    flat = np.frombuffer(seg._MC_NORMALS_PACKED.encode("ascii"), dtype=np.uint8).astype(np.float64)
    table64 = np.linalg.norm(((flat - ord("0") - 4) / 8.0).reshape(256, 4, 3), axis=-1).sum(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    edges = [S.mask_edges(preds[v], target[v], spacing=(1, 1, 1)) for v in range(volumes)]
    torch.cuda.synchronize()
    edges_s = time.perf_counter() - t0
    area_err, edge_voxels = 0.0, 0
    for v, (ep, et, ap, at) in enumerate(edges):
        codes = _codes64(np, preds[v].cpu().numpy())
        check(np.array_equal(ep.cpu().numpy(), (codes != 0) & (codes != 255)), f"BraTS volume {v}: edges")
        area_err = max(area_err, float(np.abs(ap.double().cpu().numpy() - table64[codes]).max()))
        edge_voxels += int(ep.sum())
    del edges
    check(area_err <= AREA_ATOL, f"marching-cubes areas against float64 numpy: {area_err}")

    kp, kt = kits_slices(torch, dev, gen, slices)
    edge_t, edge_p = [], []
    for i in range(slices):
        e_p, e_t = S.mask_edges(kp[i], kt[i], crop=False)
        edge_p.append(e_p)
        edge_t.append(e_t)
    pending = pool.submit(_host_distances, kt.cpu().numpy(), torch.stack(edge_t).cpu().numpy(),
                          torch.stack(edge_p).cpu().numpy())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, seconds = {m: [] for m in ("euclidean", "chessboard", "taxicab", "surface")}, {}
    for metric in ("euclidean", "chessboard", "taxicab"):
        t0 = time.perf_counter()
        for i in range(slices):
            got[metric].append(S.distance_transform(kt[i].float(), metric=metric).cpu().numpy())
        torch.cuda.synchronize()
        seconds[metric] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(slices):
        got["surface"].append(S.surface_distance(edge_p[i], edge_t[i]).cpu().numpy())
    torch.cuda.synchronize()
    seconds["surface"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    want = pending.result()
    errs = {m: max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1.0)) for g, w in zip(got[m], want[m]))
            for m in got}
    check(max(errs.values()) <= DIST_RTOL, f"distances against scipy.ndimage: {errs}")
    n_fg = int(kt.sum(dim=(1, 2)).float().mean())
    rows = max(1, seg._TILE_BYTES // (seg._TILE_MATRICES * kt.shape[1] * kt.shape[2] * 4))
    out = {"phase": "segmentation_brats_kits", "brats_volumes": volumes, "brats_shape": list(preds.shape[1:]),
           "brats_edge_voxels": edge_voxels, "mask_edges_seconds": edges_s, "area_max_err": area_err,
           "kits_slices": slices, "mean_foreground": n_fg, "tile_rows": rows,
           "tile_bytes": seg._TILE_BYTES, "distance_seconds": seconds, "peak_bytes_above_inputs": peak,
           "max_rel_err": errs, "card": smi}
    emit(out)
    return out


def audio_multimodal_segmentation(torch, np, dev, gen, seed: int, smi: str, counters: dict, t_main: float,
                                  sizes: dict) -> dict:
    """Phases 44-47, each at its entry of ``sizes`` (``AMS_SIZES`` on the card); kernel S1 launches in phase 44
    only, B1-B5 in none of them. S1's main-shape check against its plain loop on the host ends after phase 47."""
    kb = importlib.import_module("torchmetrics_tpu_torch._kernels.biquad")
    t0 = time.perf_counter()
    for counter in counters.values():
        counter.launches.reset()
    seconds = {}
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        t1 = time.perf_counter()
        srmr = phase_srmr_reverb(torch, np, kb, dev, gen, pool, smi, sizes["srmr_reverb"])
        seconds["srmr_reverb"] = time.perf_counter() - t1
        s1_after_44 = int(kb.biquad_bank.launches)
        t1 = time.perf_counter()
        phase_wsj0_2mix_separation(torch, np, dev, gen, smi, sizes["wsj0_2mix_separation"])
        seconds["wsj0_2mix_separation"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        phase_clipscore_coco_clipiqa_koniq(torch, np, dev, gen, seed, smi, pool, sizes["clipscore_coco_clipiqa_koniq"])
        seconds["clipscore_coco_clipiqa_koniq"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        phase_segmentation_brats_kits(torch, np, dev, gen, smi, pool, sizes["segmentation_brats_kits"])
        seconds["segmentation_brats_kits"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        s1_host = {mode: pending.result() for mode, pending in srmr["s1_on_host"].items()}
        s1_wait_s = time.perf_counter() - t1
    s1_main_err = max(r["max_abs_err"] for r in s1_host.values())
    check(s1_main_err == 0 and not any(r["unequal"] for r in s1_host.values()),
          f"S1 at the main path's shapes against its plain loop: {s1_host}")
    cfg = sizes["srmr_reverb"]
    emit({"phase": "srmr_reverb_s1_main_shape", "utterances": cfg["batch"], "samples": cfg["samples"],
          "channels": {"gammatone": cfg["batch"] * 23, "modulation": cfg["batch"] * 23 * 8}, **s1_host,
          "wait_seconds": s1_wait_s})
    launches = {name: int(counter.launches) for name, counter in counters.items()}
    check(not any(launches.values()), f"audio, multimodal and segmentation launched {launches}")
    check(int(kb.biquad_bank.launches) == s1_after_44, "S1 launched outside phase 44")
    out = {"phase": "audio_multimodal_segmentation", "seconds": time.perf_counter() - t0, "phase_seconds": seconds,
           "seconds_since_start": time.perf_counter() - t_main, "kernel_launches": launches,
           "s1_launches": int(kb.biquad_bank.launches)}
    emit(out)
    out["s1"] = {**srmr["kernel_entry"], "max_abs_err": max(srmr["kernel_entry"]["max_abs_err"], s1_main_err)}
    return out


def imagenet_val_data(torch, dev, gen, n_val: int = 50_000, c_in: int = 1000):
    """ImageNet-val-shaped logits and labels: ~76% of rows have their argmax on the target."""
    logits = torch.randn((n_val, c_in), generator=gen, device=dev)
    target = torch.randint(0, c_in, (n_val,), generator=gen, device=dev)
    hit = torch.rand(n_val, generator=gen, device=dev) < 0.76
    rows = torch.arange(n_val, device=dev)
    logits[rows[hit], target[hit]] += 10.0
    return logits, target


# ------------------------------------------------------------ compiled_path
# the 16 classes of the JAX package's certified default path (torchmetrics_tpu/_aot/default_path.py:80-96),
# each with the canonical batch maker of that file
DEFAULT_PATH = {
    "MeanMetric": ("aggregation", "MeanMetric", {}, "agg"),
    "MaxMetric": ("aggregation", "MaxMetric", {}, "agg"),
    "BinaryStatScores": ("classification", "BinaryStatScores", {}, "bin"),
    "BinaryAccuracy": ("classification", "BinaryAccuracy", {}, "bin"),
    "BinaryF1Score": ("classification", "BinaryF1Score", {}, "bin"),
    "BinaryConfusionMatrix": ("classification", "BinaryConfusionMatrix", {}, "bin"),
    "MulticlassAccuracy": ("classification", "MulticlassAccuracy", {"num_classes": 4}, "mc"),
    "MulticlassStatScores": ("classification", "MulticlassStatScores", {"num_classes": 4}, "mc"),
    "MultilabelAccuracy": ("classification", "MultilabelAccuracy", {"num_labels": 3}, "ml"),
    "MultilabelRankingLoss": ("classification", "MultilabelRankingLoss", {"num_labels": 3}, "ml"),
    "MeanSquaredError": ("regression", "MeanSquaredError", {}, "reg"),
    "MeanAbsoluteError": ("regression", "MeanAbsoluteError", {}, "reg"),
    "R2Score": ("regression", "R2Score", {}, "reg"),
    "PearsonCorrCoef": ("regression", "PearsonCorrCoef", {}, "reg"),
    "KLDivergence": ("regression", "KLDivergence", {}, "probs2d"),
    "TweedieDevianceScore": ("regression", "TweedieDevianceScore", {}, "reg_pos"),
}


def default_path_batch(torch, maker: str, n: int, gen, dev):
    """One batch of ``n`` rows, as ``_aot/default_path.py::_data`` draws it, from a torch generator on the card."""
    if maker == "bin":
        return torch.rand(n, generator=gen, device=dev), torch.randint(0, 2, (n,), generator=gen, device=dev)
    if maker == "mc":
        p = torch.rand((n, 4), generator=gen, device=dev)
        return p / p.sum(1, keepdim=True), torch.randint(0, 4, (n,), generator=gen, device=dev)
    if maker == "ml":
        return torch.rand((n, 3), generator=gen, device=dev), torch.randint(0, 2, (n, 3), generator=gen, device=dev)
    if maker == "reg":
        return torch.randn(n, generator=gen, device=dev), torch.randn(n, generator=gen, device=dev)
    if maker == "reg_pos":
        return torch.rand(n, generator=gen, device=dev) + 0.1, torch.rand(n, generator=gen, device=dev) + 0.1
    if maker == "probs2d":
        p, q = torch.rand((n, 5), generator=gen, device=dev), torch.rand((n, 5), generator=gen, device=dev)
        return p / p.sum(1, keepdim=True), q / q.sum(1, keepdim=True)
    return (torch.rand(n, generator=gen, device=dev),)


def _engaged(metric, cache: str = "_auto_update_fn") -> bool:
    return bool(metric.__dict__.get(cache)) and not metric._auto_disabled


def _same(torch, a, b) -> bool:
    """Bit for bit: tensors (NaN where the other has NaN), dicts, tuples, lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b) or bool((a.isnan() & b.isnan()).sum() == a.isnan().sum() == b.isnan().sum()
                                     and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _states(metric) -> dict:
    """Copies of a metric's states (a ring buffer's live rows, each tensor of a list state)."""
    ring = importlib.import_module("torchmetrics_tpu_torch.utilities.ringbuffer").RingBuffer

    def copy(v):
        return [t.clone() for t in v] if isinstance(v, list) else (v.values() if isinstance(v, ring) else v).clone()

    return {n: copy(getattr(metric, n)) for n in metric._defaults}


def phase_compiled_path(torch, np, kernel, dev, gen, logits, target, smi: str, batch: int = 1024,
                        sweep_rows=(32, 65_536), scan_steps: int = 48, ring_capacity: int = 100_000) -> dict:
    """The compiled update path on the card: CUDA graphs against the eager stream, bit for bit.

    1. ImageNet-val: a collection of MulticlassAccuracy (macro), MulticlassConfusionMatrix, Jaccard and MCC at
       1,000 classes (the last three one compute group: its head replays B1 in its graph) and a MeanMetric of the
       batch's cross-entropy, streamed once compiled and once with ``auto_compile=False``; a ``compute``, two
       ``forward``s and a ``reset`` mid-stream; the steady updates replay under
       ``torch.cuda.set_sync_debug_mode("error")``.
    2. The 16 default-path classes at the canonical 32 rows and at 65,536, compiled against eager.
    3. ``jit_update`` and ``scan_update`` of MulticlassConfusionMatrix(1000) (B1) and MeanSquaredError.
    4. A deferred violation: an out-of-range label in a compiled stream is dropped, ``compute()`` raises with the
       JAX package's message, and a compiled ``forward`` of that batch returns NaN.
    5. A ring buffer (BinaryAUROC, ``cat_state_capacity``) streamed past its capacity, compiled against eager.
    """
    import importlib
    import warnings

    import torch.nn.functional as F

    tp = importlib.import_module("torchmetrics_tpu_torch")
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    MCA, MCM = tp.classification.MulticlassAccuracy, tp.classification.MulticlassConfusionMatrix
    t_phase, b1_phase = time.perf_counter(), int(kernel.confusion_matrix_cuda.launches)
    c_in, n_val = logits.shape[1], logits.shape[0]
    starts = list(range(0, n_val, batch))
    ce_all = F.cross_entropy(logits, target, reduction="none")

    def imagenet(auto: bool) -> dict:
        kw = {"device": dev, "auto_compile": auto}
        mc = tp.MetricCollection({
            "acc": MCA(num_classes=c_in, average="macro", **kw), "cm": MCM(num_classes=c_in, **kw),
            "jac": tp.classification.MulticlassJaccardIndex(num_classes=c_in, **kw),
            "mcc": tp.classification.MulticlassMatthewsCorrCoef(num_classes=c_in, **kw),
        })
        mean_ce = tp.MeanMetric(**kw)
        launches0, graphs0 = int(kernel.confusion_matrix_cuda.launches), compile_mod.stats()
        out = {"checkpoints": {}, "forward": {}, "host_ms": [], "guarded": 0}
        steady = [b for b in range(len(starts)) if b >= 2 and b not in (10, 20, 21, 22, 30, 31, len(starts) - 1)]
        t_span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        span = [b for b in steady if b >= 32]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, s in enumerate(starts):
            p, t, ce = logits[s:s + batch], target[s:s + batch], ce_all[s:s + batch]
            if b == span[0]:
                t_span[0].record()
            if b in (20, 21):
                out["forward"][b] = {**mc(p, t), "mean_ce": mean_ce(ce)}
            elif b in steady:
                h0 = time.perf_counter()
                with _sync_guard(torch, on=auto):  # a replay reads nothing back; the eager checks do
                    mc.update(p, t)
                    mean_ce.update(ce)
                out["host_ms"].append((time.perf_counter() - h0) * 1e3)
                out["guarded"] += auto
            else:
                mc.update(p, t)
                mean_ce.update(ce)
            if b == span[-1]:
                t_span[1].record()
            if b == 10:
                out["checkpoints"][b] = {**mc.compute(), "mean_ce": mean_ce.compute()}
            if b == 30:
                mc.reset()
                mean_ce.reset()
        out["final"] = {**mc.compute(), "mean_ce": mean_ce.compute()}
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["device_span_ms_per_update"] = t_span[0].elapsed_time(t_span[1]) / len(span)
        out["b1_launches"] = int(kernel.confusion_matrix_cuda.launches) - launches0
        graphs = compile_mod.stats()
        out["graphs"] = {k: graphs[k] - graphs0[k] for k in graphs}
        out["states"] = {name: _states(m) for name, m in mc.items(keep_base=True)}
        out["states"]["mean_ce"] = _states(mean_ce)
        out["engaged"] = {name: _engaged(m) for name, m in [*mc.items(keep_base=True), ("mean_ce", mean_ce)]}
        out["reasons"] = {name: m._auto_disabled_reason for name, m in [*mc.items(keep_base=True), ("mean_ce", mean_ce)]}
        out["groups"] = [list(g) for g in mc.compute_groups.values()]
        # one more update of each kind, on fresh instances, under the profiler: the card's busy time
        tm = tp.MetricCollection({"cm": MCM(num_classes=c_in, **kw), "acc": MCA(num_classes=c_in, average="macro", **kw),
                                  "jac": tp.classification.MulticlassJaccardIndex(num_classes=c_in, **kw),
                                  "mcc": tp.classification.MulticlassMatthewsCorrCoef(num_classes=c_in, **kw)})
        tmean = tp.MeanMetric(**kw)
        p, t, ce = logits[:batch], target[:batch], ce_all[:batch]

        def one():
            tm.update(p, t)
            tmean.update(ce)

        for _ in range(3):
            one()
        # the counter against the profiler: B1 seen on the card as often as counted, replays included
        out["profile"] = device_time_by_kernel(torch, one, top=6, counted=("confmat_kernel", kernel.confusion_matrix_cuda.launches))
        launches1 = int(kernel.confusion_matrix_cuda.launches)
        one()
        out["b1_per_update"] = int(kernel.confusion_matrix_cuda.launches) - launches1
        out["launches_per_update"] = out["profile"]["launches"]
        return out

    compiled, eager = imagenet(True), imagenet(False)
    check(compiled["groups"] == eager["groups"] == [["acc"], ["cm", "jac", "mcc"]], f"groups {compiled['groups']}")
    check(all(compiled["engaged"].values()), f"compiled path not engaged: {compiled['reasons']}")
    check(not any(eager["engaged"].values()), "auto_compile=False engaged a compiled path")
    check(_same(torch, compiled["states"], eager["states"]), "compiled states != eager states")
    check(_same(torch, compiled["final"], eager["final"]), "compiled compute() != eager compute()")
    check(_same(torch, compiled["checkpoints"], eager["checkpoints"]), "mid-stream compute() differs")
    check(_same(torch, compiled["forward"], eager["forward"]), "forward values differ")
    check(compiled["b1_launches"] == eager["b1_launches"], f"B1 launches {compiled['b1_launches']} != eager {eager['b1_launches']}")
    # the group's head replays B1 once an update, the other members and the accuracy none; the profiler
    # sees as many B1 calls as the counter counts
    for run in (compiled, eager):
        counted = run["profile"].get("counted")
        check(dev.type != "cuda" or (run["b1_per_update"] == counted["counter"] == counted["profiler_calls"] == 1),
              f"B1 an update: {run['b1_per_update']} counted, {counted}")
    check(dev.type != "cuda" or (compiled["graphs"]["replayed"] > 0 and compiled["guarded"] > 0),
          "no replay under sync-debug mode")
    host = {"compiled": compiled, "eager": eager}
    imagenet_line = {
        run: {
            "updates_per_s": len(starts) / r["seconds"],
            "steady_updates_per_s": 1e3 / r["device_span_ms_per_update"],
            "host_ms_per_update": statistics.median(r["host_ms"]),
            "device_span_ms_per_update": r["device_span_ms_per_update"],
            "device_busy_ms_per_update": r["profile"]["device_busy_ms"], "idle_share": r["profile"]["idle_share"],
            "kernels_per_update": r["launches_per_update"], "b1_launches": r["b1_launches"],
            "b1_per_update": r["b1_per_update"], "b1_counted_vs_profiler": r["profile"]["counted"],
            "graphs": r["graphs"], "replays_under_sync_error": r["guarded"],
            "top_kernels": r["profile"]["top"],
        } for run, r in host.items()
    }
    emit({"phase": "compiled_path", "part": "imagenet_val_collection", "batches": len(starts), "batch": batch,
          "classes": c_in, "groups": compiled["groups"], "states_equal": True,
          **imagenet_line, "card": smi})

    # ------------------------------------------------------------ default path
    sweep = {}
    for rows in sweep_rows:
        for name, (module, cls, kwargs, maker) in DEFAULT_PATH.items():
            ctor = getattr(importlib.import_module(f"torchmetrics_tpu_torch.{module}"), cls)
            auto, plain = ctor(device=dev, **kwargs), ctor(device=dev, auto_compile=False, **kwargs)
            g = torch.Generator(device=dev).manual_seed(1234 + rows)
            for _ in range(4):
                args = default_path_batch(torch, maker, rows, g, dev)
                auto.update(*args)
                plain.update(*args)
            ok = _same(torch, _states(auto), _states(plain)) and _same(torch, auto.compute(), plain.compute())
            check(ok, f"{name} at {rows} rows: compiled != eager")
            check(_engaged(auto), f"{name} at {rows} rows did not engage: {auto._auto_disabled_reason}")
            sweep.setdefault(rows, []).append(name)
    emit({"phase": "compiled_path", "part": "default_path", "rows": list(sweep_rows),
          "classes_engaged_and_equal": {str(k): len(v) for k, v in sweep.items()}})

    # ------------------------------------------------- jit_update, scan_update
    full = starts[:scan_steps] if len(starts) > scan_steps else starts[:-1]
    stacked_p = torch.stack([logits[s:s + batch] for s in full])
    stacked_t = torch.stack([target[s:s + batch] for s in full])
    mse_p, mse_t = stacked_p[:, :, 0].contiguous(), stacked_p[:, :, 1].contiguous()
    scan_out = {}
    for label, ctor, xs, ys in (("confusion_matrix", lambda **k: MCM(num_classes=c_in, device=dev, **k), stacked_p, stacked_t),
                                ("mean_squared_error", lambda **k: tp.MeanSquaredError(device=dev, **k), mse_p, mse_t)):
        plain, jitted, scanned = ctor(auto_compile=False), ctor(), ctor()
        for i in range(len(full)):
            plain.update(xs[i], ys[i])
        l0 = int(kernel.confusion_matrix_cuda.launches)
        for i in range(len(full)):
            jitted.jit_update(xs[i], ys[i])
        jit_launches = int(kernel.confusion_matrix_cuda.launches) - l0
        l0 = int(kernel.confusion_matrix_cuda.launches)
        scanned.scan_update(xs, ys)
        scan_launches = int(kernel.confusion_matrix_cuda.launches) - l0
        for m in (jitted, scanned):
            check(_same(torch, _states(m), _states(plain)) and m.update_count == plain.update_count,
                  f"{label}: jit/scan != eager")
        # a second scan replays the graph: the kernels' own counters count its launches again
        l0 = int(kernel.confusion_matrix_cuda.launches)
        scanned.scan_update(xs, ys)
        per_call = int(kernel.confusion_matrix_cuda.launches) - l0
        torch.cuda.synchronize()
        t_scan = wall_ms(torch, lambda: scanned.scan_update(xs, ys), reps=3, warmup=0)
        scan_out[label] = {"steps": len(full), "jit_b1_launches": jit_launches, "scan_b1_launches": scan_launches,
                           "scan_b1_per_replay": per_call, "scan_ms": t_scan, "scan_ms_per_step": t_scan / len(full)}
        if label == "confusion_matrix" and dev.type == "cuda":
            check(jit_launches == len(full) == scan_launches == per_call, f"B1 launches {scan_out[label]}")
    emit({"phase": "compiled_path", "part": "jit_scan_update", **scan_out})

    # ----------------------------------------------------- deferred violation
    good = [(logits[s:s + batch], target[s:s + batch]) for s in starts[:4]]
    bad_t = good[3][1].clone()
    bad_t[7] = c_in  # one label out of range: same shape and dtype, so the compiled step replays it
    m, ref = MCA(num_classes=c_in, device=dev), MCA(num_classes=c_in, device=dev, auto_compile=False)
    for p, t in good[:3]:
        m.update(p, t)
        ref.update(p, t)
    m.update(good[3][0], bad_t)
    check(_engaged(m), "MulticlassAccuracy did not engage")
    message = None
    try:
        m.compute()
    except RuntimeError as err:
        message = str(err)
    want = f"Detected more unique values in `target` than expected. Expected only {c_in}."
    check(message is not None and message.startswith(want) and "raised asynchronously" in message,
          f"deferred violation: {message!r}")
    check(_same(torch, m.compute(), ref.compute()) and _same(torch, _states(m), _states(ref)),
          "the violating batch reached the state")
    fwd = MCA(num_classes=c_in, device=dev)
    for p, t in good[:2]:
        fwd(p, t)
    poisoned = fwd(good[3][0], bad_t)
    check(_engaged(fwd, "_auto_forward_fn") and bool(torch.isnan(poisoned)), f"forward of the bad batch gave {poisoned}")
    try:
        fwd.compute()
        check(False, "the forward's violation did not surface")
    except RuntimeError as err:
        check(str(err).startswith(want), f"forward violation message {err}")
    emit({"phase": "compiled_path", "part": "deferred_violation", "message": message, "forward_value": float(poisoned)})

    # ------------------------------------------------------------ ring buffer
    ring_batch, ring_updates = 16_384, 10
    rp = torch.rand((ring_updates, ring_batch), generator=gen, device=dev)
    rt = (torch.rand((ring_updates, ring_batch), generator=gen, device=dev) < rp).to(torch.int64)
    runs = {}
    for auto in (True, False):
        metric = tp.classification.BinaryAUROC(cat_state_capacity=ring_capacity, device=dev, auto_compile=auto)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for u in range(ring_updates):
                metric.update(rp[u], rt[u])
        runs[auto] = (metric, [str(w.message) for w in caught if "capacity" in str(w.message)])
    (mc_, warn_c), (me_, warn_e) = runs[True], runs[False]
    check(_engaged(mc_), f"BinaryAUROC ring did not engage: {mc_._auto_disabled_reason}")
    check(mc_.preds.count == me_.preds.count == ring_batch * ring_updates, "ring counts differ")
    check(torch.equal(mc_.preds.values(), me_.preds.values()) and torch.equal(mc_.target.values(), me_.target.values()),
          "ring rows differ")
    check(len(warn_c) == len(warn_e) == 2, f"overflow warnings {len(warn_c)} / {len(warn_e)}")  # preds' and target's
    check(_same(torch, mc_.compute(), me_.compute()), "ring AUROC differs")
    emit({"phase": "compiled_path", "part": "ring_buffer", "capacity": ring_capacity,
          "rows_appended": mc_.preds.count, "auroc": float(mc_.compute()), "warning": warn_c[0][:60]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "compiled_path", "seconds": seconds, "graphs": compile_mod.stats()})
    return {"confmat_launches": int(kernel.confusion_matrix_cuda.launches) - b1_phase, "seconds": seconds}


def phase_compiled_stream(torch, kernel, dev, logits, target, order, smi: str, batch: int = 1024) -> None:
    """Where a whole stream's time goes, compiled against eager, in the order given (``--phase compiled_stream``).

    Each item of ``order`` streams the imagenet_val data once through a new
    collection (macro accuracy and the 1,000-class confusion-matrix group) and
    a mean cross-entropy, ``update`` a batch and one ``compute``: ``eager``
    with ``auto_compile=False``, ``compiled`` with the default, ``traced`` the
    default under ``torch.profiler``. Each prints its seconds and every
    batch's host milliseconds by kind (a signature's first call, a capture, a
    replay); ``traced`` adds the top host rows by self time (PyTorch ops and
    CUDA runtime calls), over the stream and within each kind of batch, the
    card's busy time, and B1's calls as the profiler saw them beside the
    launch counter over the stream.
    """
    import importlib

    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tp = importlib.import_module("torchmetrics_tpu_torch")
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    c_in, starts = logits.shape[1], list(range(0, logits.shape[0], batch))
    ce_all = F.cross_entropy(logits, target, reduction="none")
    torch.cuda.synchronize()
    for item in order:
        kw = {"device": dev, "auto_compile": item != "eager"}
        mc = tp.MetricCollection({
            "acc": tp.classification.MulticlassAccuracy(num_classes=c_in, average="macro", **kw),
            "cm": tp.classification.MulticlassConfusionMatrix(num_classes=c_in, **kw),
            "jac": tp.classification.MulticlassJaccardIndex(num_classes=c_in, **kw),
            "mcc": tp.classification.MulticlassMatthewsCorrCoef(num_classes=c_in, **kw),
        })
        mean_ce = tp.MeanMetric(**kw)
        kinds, graphs0, b1_0 = [], compile_mod.stats(), int(kernel.confusion_matrix_cuda.launches)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if item == "traced" else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        for s in starts:
            h0, g0 = time.perf_counter(), compile_mod.stats()
            seen = s + batch <= logits.shape[0] and s > 0  # the first batch and the short last one are first calls
            with record_function(f"batch_{len(kinds)}"):
                mc.update(logits[s:s + batch], target[s:s + batch])
                mean_ce.update(ce_all[s:s + batch])
            g1 = compile_mod.stats()
            kind = ("capture" if g1["captured"] > g0["captured"] else "replay" if g1["replayed"] > g0["replayed"]
                    else "eager" if seen else "first_call")
            kinds.append((kind, (time.perf_counter() - h0) * 1e3))
        values = {**mc.compute(), "mean_ce": mean_ce.compute()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        check(all(bool(torch.isfinite(v.float()).all()) for v in values.values()), f"{item}: non-finite results")
        by_kind = {}
        for kind, ms in kinds:
            entry = by_kind.setdefault(kind, {"batches": 0, "host_ms": 0.0, "max_ms": 0.0})
            entry["batches"] += 1
            entry["host_ms"] += ms
            entry["max_ms"] = max(entry["max_ms"], ms)
        graphs = compile_mod.stats()
        line = {"phase": "compiled_stream", "item": item, "batches": len(starts), "seconds": seconds,
                "updates_per_s": len(starts) / seconds, "host_ms_by_kind": by_kind,
                "slowest_batches": sorted(((round(ms, 3), b, kind) for b, (kind, ms) in enumerate(kinds)), reverse=True)[:6],
                "graphs": {k: graphs[k] - graphs0[k] for k in graphs},
                "b1_launches": int(kernel.confusion_matrix_cuda.launches) - b1_0, "card": smi}
        if prof is not None:
            rows = prof.key_averages()
            host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in rows
                           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0), key=lambda r: -r[1])
            device = [(e.key, e.self_device_time_total / 1e3, e.count) for e in rows
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            line.update({
                "host_self_ms_total": sum(r[1] for r in host),
                "top_host_rows": [{"row": k[:60], "self_ms": ms, "calls": n} for k, ms, n in host[:20]],
                "device_busy_ms": sum(r[1] for r in device),
                "kernel_calls": sum(r[2] for r in device),
                "b1_profiler_calls": sum(n for k, _, n in device if "confmat_kernel" in k),
            })
            # each host event's self time, by the kind of the batch it ran in
            spans = [(e.time_range.start, e.time_range.end, kinds[int(e.name[6:])][0])
                     for e in prof.events() if e.name.startswith("batch_")]
            by_batch_kind = {}
            for e in prof.events():
                if e.device_type != DeviceType.CPU or e.name.startswith("batch_") or e.self_cpu_time_total <= 0:
                    continue
                kind = next((k for a, b, k in spans if a <= e.time_range.start <= b), "outside")
                by_batch_kind.setdefault(kind, collections.Counter())[e.name[:60]] += e.self_cpu_time_total / 1e3
            line["top_host_rows_by_batch_kind"] = {
                k: {"self_ms": sum(c.values()), "top": [[n, ms] for n, ms in c.most_common(6)]}
                for k, c in by_batch_kind.items()}
            check(dev.type != "cuda" or line["b1_profiler_calls"] == line["b1_launches"],
                  f"B1: {line['b1_profiler_calls']} calls seen, {line['b1_launches']} counted")
        emit(line)


# ------------------------------------------------------------ observability
OBS_SIZES = {"updates": 100, "chunk": 20, "batch": 1024, "fid_batches": 10, "fid_batch": 200, "trunk_batches": 4,
             "sleep_cycles": 200_000_000}
LEDGER_RTOL = 0.10  # the ledger's device seconds against one outer event pair: the gaps between replays are not in it


def phase_observability(torch, np, kernel, ce, dev, gen, logits, target, npz_folder: str, seed: int, smi: str,
                        sizes=OBS_SIZES) -> dict:
    """The runtime telemetry on the card: switches off, switches on, the FID gauges and a flight dump.

    The imagenet_val collection of phase 48 (macro accuracy, the 1,000-class confusion-matrix group, a mean
    cross-entropy), compiled, streams ``updates`` batches after two warm-up calls (the first eager, the second
    captured), in chunks of ``chunk`` queued behind a ``torch.cuda._sleep`` so the card runs each chunk's replays
    back to back. Off: no telemetry object, no span, no ledger bucket, B1 once an update. On (telemetry, tracing,
    profiling): the counters the routes imply, one span a call, a Chrome trace that parses, and the ledger's
    device seconds (one CUDA event pair a replay) within ``LEDGER_RTOL`` of the outer pairs around the chunks.
    Then ``fid_batches`` compiled FID updates of ``fid_batch`` (the capture counts the flops), ``trunk_batches``
    more on ``auto_compile=False`` (the trunk's own graph: a ``trunk_forward`` compile event and ledger seam),
    and one ``auto_path_disabled`` event frozen by the flight recorder into a temporary directory.
    """
    import torch.nn.functional as F

    tp = importlib.import_module("torchmetrics_tpu_torch")
    obs = importlib.import_module("torchmetrics_tpu_torch._observability")
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    t_phase = time.perf_counter()
    n, chunk, batch = sizes["updates"], sizes["chunk"], sizes["batch"]
    c_in = logits.shape[1]
    starts = list(range(0, logits.shape[0] - batch + 1, batch))  # full batches: one signature
    ce_all = F.cross_entropy(logits, target, reduction="none")
    b1 = kernel.confusion_matrix_cuda.launches
    check(not (obs.OBS.enabled or obs.OBS.tracing or obs.OBS.profiling), "a telemetry switch is on by default")

    def stream() -> dict:
        kw = {"device": dev}
        mc = tp.MetricCollection({
            "acc": tp.classification.MulticlassAccuracy(num_classes=c_in, average="macro", **kw),
            "cm": tp.classification.MulticlassConfusionMatrix(num_classes=c_in, **kw),
            "jac": tp.classification.MulticlassJaccardIndex(num_classes=c_in, **kw),
            "mcc": tp.classification.MulticlassMatthewsCorrCoef(num_classes=c_in, **kw),
        })
        mean_ce = tp.MeanMetric(**kw)
        batches = [(logits[s:s + batch], target[s:s + batch], ce_all[s:s + batch]) for s in starts]

        def update(i):
            p, t, c = batches[i % len(batches)]
            mc.update(p, t)
            mean_ce.update(c)

        b1_start = int(b1)
        for i in range(2):  # the signature's first call (eager) and its capture
            update(i)
        torch.cuda.synchronize()
        obs.LEDGER.reset()  # from here the ledger holds the steady replays alone
        b1_0, spans_0 = int(b1), obs.TRACER.recorded
        host_ms, outer_ms = [], 0.0
        for lo in range(0, n, chunk):
            torch.cuda._sleep(sizes["sleep_cycles"])  # the chunk queues up behind it, then runs back to back
            t_span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            t_span[0].record()
            for i in range(lo, min(lo + chunk, n)):
                h0 = time.perf_counter()
                update(2 + i)
                host_ms.append((time.perf_counter() - h0) * 1e3)
            t_span[1].record()
            t_span[1].synchronize()
            outer_ms += t_span[0].elapsed_time(t_span[1])
        b1_end = int(b1)
        return {"mc": mc, "mean_ce": mean_ce, "host_ms": host_ms, "outer_ms": outer_ms, "b1_launches": b1_end - b1_start,
                "b1_per_update": (b1_end - b1_0) / n, "spans": obs.TRACER.recorded - spans_0}

    # ------------------------------------------------------------ switches off
    obs.REGISTRY.reset()
    obs.TRACER.clear()
    obs.reset_ledger()
    off = stream()
    members = [m for _, m in off["mc"].items(keep_base=True)] + [off["mean_ce"]]
    check(not obs.REGISTRY.telemetries() and not any("_telem" in m.__dict__ for m in members),
          "switches off: a telemetry object was made")
    check(obs.TRACER.recorded == 0 and not obs.LEDGER.snapshot()["seams"], "switches off: a span or a ledger entry")
    check(off["b1_per_update"] == 1, f"switches off: B1 {off['b1_per_update']} an update")
    check(all(_engaged(m) for m in (off["mc"]["acc"], off["mc"]["cm"], off["mean_ce"])), "switches off: not compiled")
    off_line = {"host_ms_per_update": statistics.median(off["host_ms"]), "outer_pair_ms": off["outer_ms"],
                "b1_per_update": off["b1_per_update"]}
    b1_launches = off["b1_launches"]
    del off, members
    release_graphs(torch)

    # ------------------------------------------------------------- switches on
    obs.set_telemetry_enabled(True)
    obs.set_tracing_enabled(True)
    obs.set_profiling_enabled(True)
    try:
        on = stream()
        ledger = obs.LEDGER.snapshot()  # waits for every pending event pair
        trace = json.loads(json.dumps(obs.export_chrome_trace()))
        reports = on["mc"].telemetry_report()
        reports["mean_ce"] = on["mean_ce"].telemetry_report()
    finally:
        obs.set_profiling_enabled(False)
        obs.set_tracing_enabled(False)
    # the routes the stream implies: every member's first call eager, then the group heads (acc, cm) and the
    # mean replay; jac and mcc read the head's states. The eager call of a class the analyzer certified R1-clean
    # skips the fingerprint (`_analysis/certified.json`), as in the JAX package
    total = n + 2
    heads = {"acc": "MulticlassAccuracy", "cm": "MulticlassConfusionMatrix", "mean_ce": "MeanMetric"}
    cert = importlib.import_module("torchmetrics_tpu_torch._analysis.manifest")
    classes = {**{k: type(m) for k, m in on["mc"].items(copy_state=False)}, "mean_ce": type(on["mean_ce"])}
    for name, rep in reports.items():
        head = name in heads
        outcome = "skip" if cert.fingerprint_skip_allowed(classes[name]) else "check"
        want = {"compiles|kind=auto_update": 1, f"fingerprint|outcome={outcome}": 1, "update_calls|path=eager": 1}
        if head:
            want.update({"update_calls|path=auto_compiled": total - 1})
        got = {k: v for k, v in rep.counters.items() if not k.startswith("latency_") and k != "trace_seconds"}
        check(got == want and (not head or rep.counters.get("trace_seconds", 0) > 0),
              f"switches on: {name} counters {got}, expected {want}")
    # one span a collection update, one a head's update and a mean update; the first update reaches all four members
    want_spans = n * (1 + 2 + 1)
    check(on["spans"] == want_spans, f"switches on: {on['spans']} spans for {n} updates, expected {want_spans}")
    check(len(trace["traceEvents"]) == len(obs.TRACER.spans()) and trace["displayTimeUnit"] == "ms",
          "switches on: the Chrome trace does not hold the spans")
    rows = {(r["seam"], r["class"]): r for r in ledger["seams"]}
    check(set(rows) == {("update_compiled", c) for c in heads.values()} and all(r["steps"] == n for r in rows.values()),
          f"switches on: ledger buckets {[(k, r['steps']) for k, r in rows.items()]}")
    device_ms = 1e3 * sum(r["device_seconds"] for r in rows.values())
    check(abs(device_ms - on["outer_ms"]) <= LEDGER_RTOL * on["outer_ms"],
          f"switches on: ledger {device_ms} ms against an outer pair's {on['outer_ms']} ms")
    check(on["b1_per_update"] == 1 and on["b1_launches"] == b1_launches,
          f"switches on: B1 {on['b1_per_update']} an update, {on['b1_launches']} in the stream (off: {b1_launches})")
    b1_launches += on["b1_launches"]
    on_line = {"host_ms_per_update": statistics.median(on["host_ms"]), "b1_per_update": on["b1_per_update"], "spans": on["spans"],
               "ledger_device_ms": device_ms, "outer_pair_ms": on["outer_ms"],
               "ledger_over_outer": device_ms / on["outer_ms"],
               "counters": {k: {c: v for c, v in r.counters.items() if not c.startswith("latency_")}
                            for k, r in reports.items()}}
    del on
    release_graphs(torch)

    # ----------------------------------------------------------- FID gauges
    npz = inception_npz(torch, np, seed, npz_folder, dev, gen)
    fb = sizes["fid_batch"]
    imgs = [torch.randint(0, 256, (fb, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
            for _ in range(sizes["fid_batches"])]
    l0 = int(ce.matmul_bias_relu.launches), int(ce.bias_relu_.launches)
    obs.reset_ledger()
    obs.set_profiling_enabled(True)
    try:
        fid = FrechetInceptionDistance(feature=2048, weights_path=npz)
        for x in imgs:  # one signature: its first call eager, its second captured (the flops counted), then replays
            fid.update(x, real=True)
        fid_ledger = obs.LEDGER.snapshot()
        # the trunk's own graph, where the metric streams eagerly: captured at its second call, then replayed
        obs.reset_ledger()
        eager_fid = FrechetInceptionDistance(feature=2048, weights_path=npz, auto_compile=False)
        for x in imgs[:sizes["trunk_batches"]]:
            eager_fid.update(x, real=True)
        trunk_ledger = obs.LEDGER.snapshot()
        trunk_counters = {k: v for t in obs.REGISTRY.telemetries() if t.name.startswith("CapturedForward[")
                          for k, v in t.counters.items() if not k.startswith("latency_")}
    finally:
        obs.set_profiling_enabled(False)
    fid_launches = int(ce.matmul_bias_relu.launches) - l0[0], int(ce.bias_relu_.launches) - l0[1]
    forwards = sizes["fid_batches"] + sizes["trunk_batches"]
    (row,) = [r for r in fid_ledger["seams"] if r["class"] == "FrechetInceptionDistance"]
    (exe,) = [e for e in fid_ledger["executables"].values() if e["class"] == "FrechetInceptionDistance"]
    mfu = row.get("mfu")
    check(_engaged(fid) and row["steps"] == sizes["fid_batches"] - 2 and exe["flops"] > 0,
          f"FID gauges: {row}, {exe}")
    check(mfu is not None and 0 < mfu <= 1, f"FID gauges: MFU {mfu}")
    check(fid_launches == (40 * forwards, 54 * forwards), f"FID launches {fid_launches}, {forwards} forwards")
    (trunk_row,) = trunk_ledger["seams"]
    (trunk_exe,) = trunk_ledger["executables"].values()
    check(trunk_row["seam"] == "trunk_forward" and trunk_row["steps"] == sizes["trunk_batches"] - 2
          and trunk_exe["kind"] == "trunk_forward" and trunk_exe["flops"] > 0
          and trunk_counters.get("compiles|kind=trunk_forward") == 1 and trunk_counters.get("trace_seconds", 0) > 0,
          f"trunk graph: {trunk_row}, {trunk_exe}, {trunk_counters}")
    fid_line = {"batches": sizes["fid_batches"], "batch": fb, "flops_per_image": exe["flops"] / fb,
                "bytes_per_step": exe["bytes_accessed"], "capture_seconds": exe["compile_seconds"],
                "steps": row["steps"], "device_ms_per_step": 1e3 * row["device_seconds"] / row["steps"],
                "mfu": mfu, "roofline_ceiling": row.get("roofline_ceiling"), "ceilings": fid_ledger["ceilings"],
                "trunk_graph": {"class": trunk_row["class"], "steps": trunk_row["steps"],
                                "flops_per_image": trunk_exe["flops"] / fb, "mfu": trunk_row.get("mfu"),
                                "device_ms_per_step": 1e3 * trunk_row["device_seconds"] / trunk_row["steps"]}}
    del fid, eager_fid
    release_graphs(torch)

    # ----------------------------------------------------------- flight dump
    class Counting(tp.Metric):
        """A metric whose update also counts its calls in a plain attribute: a replay would freeze the count."""

        def __init__(self):
            super().__init__(device=dev)
            self.add_state("total", torch.zeros((), device=dev), dist_reduce_fx="sum")
            self.calls = 0

        def update(self, x):
            self.total += x.sum()
            self.calls += 1

        def compute(self):
            return self.total

    with tempfile.TemporaryDirectory() as flight_dir:
        recorder = obs.arm_flight_recorder(directory=flight_dir)
        try:
            counting = Counting()
            counting.update(ce_all[:batch])
            (event,) = obs.BUS.events(kind="auto_path_disabled", source="Counting")
            check(recorder.dump_count == 0, "auto_path_disabled is not a trigger kind, as in the JAX package")
            dump = recorder.dump(event)  # freeze the post-mortem of this one event
            files = sorted(os.listdir(flight_dir))
            on_disk = json.loads(open(os.path.join(flight_dir, files[0]), encoding="utf-8").read()) if files else {}
        finally:
            obs.disarm_flight_recorder()
            obs.set_telemetry_enabled(False)
    check(len(files) == 1 and on_disk == dump and dump["seam"] == "metric.update"
          and dump["trigger"]["kind"] == "auto_path_disabled" and "unregistered" in dump["trigger"]["detail"],
          f"flight dump: {files}, seam {dump.get('seam')}")
    flight_line = {"file": files[0], "seam": dump["seam"], "source": dump["trigger"]["source"],
                   "detail": dump["trigger"]["detail"], "timeline": len(dump["timeline"])}
    obs.REGISTRY.reset()
    obs.BUS.clear()
    obs.TRACER.clear()
    obs.reset_ledger()
    seconds = time.perf_counter() - t_phase
    line = {"phase": "observability", "updates": n, "batch": batch, "classes": c_in,
            "off": off_line, "on": on_line, "fid_gauges": fid_line, "flight": flight_line,
            "seconds": seconds, "card": smi}
    emit(line)
    return {"seconds": seconds, "b1_launches": b1_launches, "fid_launches": fid_launches}


# ----------------------------------------------------------------- resilience
RES_SIZES = {"batch": 1024, "poisoned": (5, 17, 33), "kill_after": 29, "every_n": 8, "keep": 2,
             "chaos_metric_seeds": (0, 1, 2), "chaos_collection_seed": 100, "chaos_stall_seed": 101}
RES_LOSS_RTOL = 1e-5  # float32 sums of 46 batch means' terms (~47,000 CEs of 3-10) against float64


def _resilience_collection(tp, c_in: int, dev, nan_policy=None):
    """BASELINE config 2's members, a NaN-sensitive mean loss and ECE (cat states: the sentinel's incremental scan)."""
    cls, kw = tp.classification, {"device": dev}
    mc = tp.MetricCollection({
        "acc": cls.MulticlassAccuracy(num_classes=c_in, **kw),
        "precision": cls.MulticlassPrecision(num_classes=c_in, **kw),
        "recall": cls.MulticlassRecall(num_classes=c_in, **kw),
        "f1": cls.MulticlassF1Score(num_classes=c_in, **kw),
        "auroc_binned": cls.MulticlassAUROC(num_classes=c_in, thresholds=100, **kw),
        "cm": cls.MulticlassConfusionMatrix(num_classes=c_in, **kw),
        # `disable`: a NaN reaches the state (the default `warn` drops NaNs before the sentinel could see them)
        "loss": tp.MeanMetric(nan_strategy="disable", **kw),
        "ece": cls.MulticlassCalibrationError(num_classes=c_in, n_bins=15, **kw),
    })
    if nan_policy is not None:
        mc.set_resilience_policy(nan_policy=nan_policy)
    return mc


def _host_states(mc) -> dict:
    """Every state as host numpy (``state_dict(all_states=True)``), and each member's update count."""
    out = mc.state_dict(all_states=True, _host=True)
    out.update({f"{name}.#count": m.update_count for name, m in mc.items(keep_base=True)})
    return out


def _same_bytes(np, a: dict, b: dict) -> list:
    """Keys whose values differ in dtype, shape or a single byte."""
    def flat(v):
        return v if isinstance(v, list) else [v]

    bad = sorted(set(a) ^ set(b))
    for key in set(a) & set(b):
        xs, ys = flat(a[key]), flat(b[key])
        if len(xs) != len(ys) or any(
            np.asarray(x).dtype != np.asarray(y).dtype or np.shape(x) != np.shape(y)
            or np.asarray(x).tobytes() != np.asarray(y).tobytes() for x, y in zip(xs, ys)
        ):
            bad.append(key)
    return bad


def _compute_diffs(torch, got: dict, want: dict) -> dict:
    """``{key: max abs difference}`` of two ``compute()`` dicts (0.0 where bit for bit)."""
    out = {}
    for key in want:
        g, w = got[key], want[key]
        same = g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        out[key] = 0.0 if same else float((g.double() - w.double()).abs().max())
    return out


_NCCL_CHILD = r"""
import json, sys, time, warnings
warnings.simplefilter("ignore")
sys.path.insert(0, sys.argv[2])
import torch
import torch.distributed as dist
from torchmetrics_tpu_torch._resilience import RetryPolicy, SyncPolicy
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as kernel
port, seed = int(sys.argv[1]), int(sys.argv[3])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
try:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = MulticlassConfusionMatrix(num_classes=1000, sync_policy=SyncPolicy(retry=RetryPolicy(timeout=60.0, max_retries=0)))
    for _ in range(3):
        m.update(torch.randint(0, 1000, (1024,), generator=gen, device="cuda"),
                 torch.randint(0, 1000, (1024,), generator=gen, device="cuda"))
    local = m.confmat.clone()
    ms, equal = [], []
    for _ in range(2):  # the first sync runs the handshake and the gather, the second the gather alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.sync()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        equal.append(bool(m._is_synced) and bool(torch.equal(m.confmat, local)))
        m.unsync()
    print(json.dumps({"backend": dist.get_backend(), "world": dist.get_world_size(),
                      "handshake_and_gather_ms": ms[0], "gather_ms": ms[1], "equal_unsynced": all(equal),
                      "healthy": m.resilience_report().healthy, "handshake_cached": "_handshake_ok_digest" in m.__dict__,
                      "b1_launches": int(kernel.confusion_matrix_cuda.launches)}))
finally:
    dist.destroy_process_group()
"""


def phase_resilience(torch, np, kernel, dev, logits, target, seed: int, smi: str) -> dict:
    """The resilience runtime on the card, on the imagenet_val data through BASELINE config 2's collection.

    1. Quarantine and durability, eager: ``nan_policy="quarantine"``, batches ``poisoned`` NaN-poisoned on the
       card, a ``SnapshotManager`` journaling every update, a preemption after ``kill_after`` updates, a restore
       into a fresh collection and the rest of the stream: states bit for bit with an uninterrupted stream,
       three quarantines on ``loss`` and ``ece``, ``loss`` against float64, ``cm`` against a host bincount, two
       more fresh restores byte-identical.
    2. The same kill and restore on the compiled path (clean batches, B1 replayed from graphs), bit for bit,
       with the host ms of a compiled update with and without a manager.
    3. Integrity: a corrupted ``cm`` state refused with every member untouched, repaired alone, and an
       integrity-checked ``merge_state``.
    4. Guarded sync in a simulated world of 2 (a retried and a degraded sync), then a one-rank NCCL guarded
       sync in a spawned child (no process group leaks into the other phases).
    5. The chaos smoke schedules with factories on the card.
    """
    import torch.nn.functional as F

    tp = importlib.import_module("torchmetrics_tpu_torch")
    res = importlib.import_module("torchmetrics_tpu_torch._resilience")
    fi = importlib.import_module("torchmetrics_tpu_torch._resilience.faultinject")
    chaos = importlib.import_module("torchmetrics_tpu_torch._resilience.chaos")

    t_phase = time.perf_counter()
    b1 = kernel.confusion_matrix_cuda.launches
    sizes = RES_SIZES
    n_val, c_in = logits.shape
    batch, poisoned, kill = sizes["batch"], set(sizes["poisoned"]), sizes["kill_after"]
    starts = list(range(0, n_val, batch))
    n_b = len(starts)
    tgts = [target[s:s + batch] for s in starts]
    clean_p = [logits[s:s + batch] for s in starts]
    poisoned_p = [fi.poison_nans(p, frac=0.5) if i in poisoned else p for i, p in enumerate(clean_p)]
    batches = {
        "poisoned": [(p, t, F.cross_entropy(p, t, reduction="none")) for p, t in zip(poisoned_p, tgts)],
        "clean": [(p, t, F.cross_entropy(p, t, reduction="none")) for p, t in zip(clean_p, tgts)],
    }
    cm_updates = 0

    def make(policy=None):
        return _resilience_collection(tp, c_in, dev, policy)

    def update(mc, kind, i, host_ms=None):
        nonlocal cm_updates
        p, t, c = batches[kind][i]
        h0 = time.perf_counter()
        mc.update(preds=p, target=t, value=c)  # each member takes its own arguments (`_filter_kwargs`)
        if host_ms is not None:
            host_ms.append((time.perf_counter() - h0) * 1e3)
        cm_updates += 1

    def policy(**kw):
        return res.SnapshotPolicy(every_n_updates=sizes["every_n"], keep=sizes["keep"], **kw)

    def restore_into(directory, **kw):
        nonlocal cm_updates
        mc = make(kw.pop("nan_policy", None))
        mgr = res.SnapshotManager(mc, directory, policy(**kw))
        report = mgr.restore_latest()
        cm_updates += report.replayed  # every journaled entry is a collection update
        return mc, mgr, report

    # ------------------------------------------------ 1. quarantine and durability, eager
    b1_0 = int(b1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the quarantines and the restore warn by design
        ref = make("quarantine")
        for i in range(n_b):
            update(ref, "poisoned", i)
        with tempfile.TemporaryDirectory() as folder:
            live = make("quarantine")
            mgr = res.SnapshotManager(live, folder, policy())
            t0 = time.perf_counter()
            for i in range(kill):
                update(live, "poisoned", i)
            journaled_ms = (time.perf_counter() - t0) * 1e3 / kill
            mgr.simulate_preemption()
            restored, mgr2, r1 = restore_into(folder, nan_policy="quarantine")
            for i in range(kill, n_b):
                update(restored, "poisoned", i)
            mgr2.close()
            again = [restore_into(folder, nan_policy="quarantine", async_write=False) for _ in range(2)]
            for _, m, _ in again:
                m.close()
    ref_states, restored_states = _host_states(ref), _host_states(restored)
    again_states = [_host_states(mc) for mc, _, _ in again]
    check(not _same_bytes(np, restored_states, ref_states),
          f"eager restore: states differ from the uninterrupted stream: {_same_bytes(np, restored_states, ref_states)}")
    check(not _same_bytes(np, again_states[0], again_states[1]) and not _same_bytes(np, again_states[0], ref_states),
          "a second fresh restore is not byte-identical")
    ref_vals, restored_vals = ref.compute(), restored.compute()
    eager_diffs = _compute_diffs(torch, restored_vals, ref_vals)
    # ECE bins its confidences with float32 index_add_, whose order of adds on the card varies from call to call:
    # its states are bit for bit (above), its value is held to CALIBRATION_ATOL
    check(all(v == 0.0 for k, v in eager_diffs.items() if k != "ece") and eager_diffs["ece"] <= CALIBRATION_ATOL,
          f"eager restore: compute() differs: {eager_diffs}")
    q_ref = {k: r.quarantined_updates for k, r in ref.resilience_report().items()}
    q_split = {k: live.resilience_report()[k].quarantined_updates + r.quarantined_updates
               for k, r in restored.resilience_report().items()}
    want_q = {k: (len(poisoned) if k in ("loss", "ece") else 0) for k in q_ref}
    check(q_ref == want_q and q_split == want_q, f"quarantines: uninterrupted {q_ref}, killed + restored {q_split}")
    clean_idx = [i for i in range(n_b) if i not in poisoned]
    host_logits, host_target = logits.cpu().numpy(), target.cpu().numpy()
    ce_sum, ce_n = 0.0, 0
    for i in clean_idx:
        x = host_logits[starts[i]:starts[i] + batch].astype(np.float64)
        t = host_target[starts[i]:starts[i] + batch]
        m = x.max(axis=1)
        ce_sum += float((m + np.log(np.exp(x - m[:, None]).sum(axis=1)) - x[np.arange(len(t)), t]).sum())
        ce_n += len(t)
    loss_rel = abs(float(ref_vals["loss"]) - ce_sum / ce_n) / (ce_sum / ce_n)
    check(loss_rel <= RES_LOSS_RTOL, f"loss {float(ref_vals['loss'])} against float64 {ce_sum / ce_n}")
    labels = np.concatenate([torch.argmax(p, dim=1).cpu().numpy() for p, _, _ in batches["poisoned"]])
    host_cm = np.bincount(host_target * c_in + labels, minlength=c_in * c_in).reshape(c_in, c_in)
    check(np.array_equal(ref_vals["cm"].cpu().numpy(), host_cm), "cm != host bincount of torch's argmax labels")
    part1_b1 = int(b1) - b1_0
    check(part1_b1 == cm_updates, f"B1 {part1_b1} launches for {cm_updates} cm updates")
    eager_line = {"updates": n_b, "poisoned": sorted(poisoned), "kill_after": kill,
                  "restore": {"generation": r1.generation, "replayed": r1.replayed, "fell_back": r1.fell_back},
                  "again_replayed": [r.replayed for _, _, r in again], "quarantined": q_ref,
                  "quarantined_killed_plus_restored": q_split, "loss": float(ref_vals["loss"]),
                  "loss_rel_err_vs_float64": loss_rel, "ece_diff": eager_diffs["ece"],
                  "journaled_update_ms": journaled_ms, "b1_launches": part1_b1, "cm_updates": cm_updates}
    del live, again

    # ------------------------------------------------ 2. durability on the compiled path
    b1_1, cm_1 = int(b1), cm_updates
    ms_plain, ms_managed = [], []
    ref2 = make()
    for i in range(n_b):
        update(ref2, "clean", i, ms_plain)
    with tempfile.TemporaryDirectory() as folder:
        live2 = make()
        mgr = res.SnapshotManager(live2, folder, policy())
        for i in range(kill):
            update(live2, "clean", i, ms_managed)
        mgr.simulate_preemption()
        restored2, mgr2, r2 = restore_into(folder)
        for i in range(kill, n_b):
            update(restored2, "clean", i)
        mgr2.close()
    routes = {name: _engaged(m) for name, m in restored2.items(keep_base=True)}
    check(all(routes[k] for k in ("acc", "auroc_binned", "cm", "loss")) and not routes["ece"]
          and routes == {name: _engaged(m) for name, m in ref2.items(keep_base=True)},
          f"compiled routes after the restore: {routes}")
    bad = _same_bytes(np, _host_states(restored2), _host_states(ref2))
    check(not bad, f"compiled restore: states differ from the uninterrupted compiled stream: {bad}")
    compiled_diffs = _compute_diffs(torch, restored2.compute(), ref2.compute())
    check(all(v == 0.0 for k, v in compiled_diffs.items() if k != "ece") and compiled_diffs["ece"] <= CALIBRATION_ATOL,
          f"compiled restore: compute() differs: {compiled_diffs}")
    part2_b1 = int(b1) - b1_1
    check(part2_b1 == cm_updates - cm_1, f"B1 {part2_b1} launches for {cm_updates - cm_1} cm updates")
    steady = slice(2, kill)  # past the eager first call and the capture; the managed stream's updates
    compiled_line = {"restore": {"generation": r2.generation, "replayed": r2.replayed}, "routes": routes,
                     "host_ms_per_update_no_manager": statistics.median(ms_plain[steady]),
                     "host_ms_per_update_with_manager": statistics.median(ms_managed[steady]),
                     "ece_diff": compiled_diffs["ece"], "b1_launches": part2_b1}
    del live2, restored2, ref2

    # ------------------------------------------------ 3. integrity
    b1_2 = int(b1)
    sd = ref.state_dict(integrity=True, all_states=True)
    bad_sd = fi.corrupt_state_dict(sd, key="cm.confmat")
    victim = make()
    update(victim, "clean", 0)
    before = _host_states(victim)
    try:
        victim.load_state_dict(bad_sd)
        refused = None
    except res.StateCorruptionError as err:
        refused = sorted(err.corrupted)
    check(refused == ["cm.confmat"] and not _same_bytes(np, _host_states(victim), before),
          f"a corrupted cm: refused {refused}, members untouched: {not _same_bytes(np, _host_states(victim), before)}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        victim.load_state_dict(bad_sd, strict="repair")
    repaired = {k: [e.kind for e in r.events] for k, r in victim.resilience_report().items()}
    after = victim.state_dict(all_states=True, _host=True)
    want = {k: v for k, v in ref.state_dict(all_states=True, _host=True).items() if not k.startswith("cm.")}
    check(not victim["cm"].confmat.any() and repaired == {k: (["state_repair"] if k == "cm" else []) for k in repaired}
          and not _same_bytes(np, {k: v for k, v in after.items() if not k.startswith("cm.")}, want),
          f"repair: {repaired}")
    merged = [tp.classification.MulticlassConfusionMatrix(num_classes=c_in, device=dev) for _ in range(2)]
    for m in merged:
        m.update(*batches["clean"][1][:2])
        cm_updates += 1
    merged[0].merge_state(ref["cm"].state_dict(all_states=True, integrity=True))
    merged[1].merge_state(ref["cm"].state_dict(all_states=True))
    check(torch.equal(merged[0].confmat, merged[1].confmat), "integrity-checked merge_state != plain merge")
    integrity_line = {"refused": refused, "repaired": repaired, "merge_equal": True,
                      "digests": len(sd["cm.#integrity"]["states"]), "b1_launches": int(b1) - b1_2}

    # ------------------------------------------------ 4. guarded sync
    b1_3 = int(b1)
    gs = make()
    for i in range(3):
        update(gs, "clean", i)
    local = {name: m.state_dict(all_states=True) for name, m in gs.items(keep_base=True)}
    gs.set_resilience_policy(sync_policy=res.SyncPolicy(retry=res.RetryPolicy(max_retries=2, backoff_base=0.01, backoff_max=0.05)))
    with fi.simulated_world(2), fi.inject_collective_failure(first_n=2) as stats:
        t0 = time.perf_counter()
        synced = gs.compute()
        retried_ms = (time.perf_counter() - t0) * 1e3
    healthy = {k: r.healthy for k, r in gs.resilience_report().items()}
    check(stats.injected == 2 and all(healthy.values()), f"retried sync: {stats}, healthy {healthy}")
    check(torch.equal(synced["cm"], 2 * local["cm"]["confmat"]), "retried sync: cm is not the doubled local sum")
    check(torch.equal(gs["cm"].confmat, local["cm"]["confmat"]), "retried sync: the local state was not restored")
    lone = tp.classification.MulticlassConfusionMatrix(
        num_classes=c_in, device=dev, sync_policy=res.SyncPolicy(handshake=False, retry=res.RetryPolicy(timeout=0.5, max_retries=0)))
    lone.update(*batches["clean"][0][:2])
    cm_updates += 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fi.simulated_world(2), fi.inject_collective_timeout(first_n=99, hang=5.0):
            t0 = time.perf_counter()
            degraded = lone.compute()
            degraded_ms = (time.perf_counter() - t0) * 1e3
    events = [e.kind for e in lone.resilience_report().events]
    check(events == ["sync_degraded"] and torch.equal(degraded, lone.confmat) and degraded_ms < 2000.0,
          f"degraded sync: {events}, {degraded_ms} ms")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    child = subprocess.run([sys.executable, "-c", _NCCL_CHILD, str(port), os.path.dirname(os.path.abspath(__file__)),
                            str(seed)], capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"the NCCL child failed: {child.stderr[-2000:]}")
    nccl = json.loads(child.stdout.strip().splitlines()[-1])
    check(nccl["backend"] == "nccl" and nccl["world"] == 1 and nccl["equal_unsynced"] and nccl["healthy"]
          and nccl["handshake_cached"], f"the NCCL child: {nccl}")
    sync_line = {"retried": {"injected": stats.injected, "calls": stats.calls, "ms": retried_ms},
                 "degraded": {"events": events, "ms": degraded_ms}, "nccl_child": nccl, "b1_launches": int(b1) - b1_3}
    del gs, lone, victim, merged

    # ------------------------------------------------ 5. chaos smoke on the card
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric_factory = lambda: chaos.default_metric_factory(device=dev)  # noqa: E731
        runs = [chaos.run_chaos_schedule(s, factory=metric_factory) for s in sizes["chaos_metric_seeds"]]
        runs.append(chaos.run_chaos_schedule(sizes["chaos_collection_seed"],
                                             factory=lambda: chaos.default_collection_factory(device=dev)))
        runs.append(chaos.run_chaos_schedule(sizes["chaos_stall_seed"], factory=metric_factory,
                                             spec=chaos.ChaosSpec(stall_final=True)))
    check(all(r.ok for r in runs), "chaos: " + "; ".join(r.describe() for r in runs if not r.ok))
    chaos_line = [{"seed": r.seed, "seconds": r.elapsed_s, "preemptions": r.preemptions, "replayed": r.replayed_total,
                   "faults": sorted({e.kind for e in r.events})} for r in runs]

    b1_launches = int(b1) - b1_0
    check(b1_launches == cm_updates, f"B1 {b1_launches} launches for {cm_updates} cm updates")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "resilience", "samples": n_val, "classes": c_in, "batch": batch, "eager": eager_line,
          "compiled": compiled_line, "integrity": integrity_line, "guarded_sync": sync_line, "chaos": chaos_line,
          "b1_launches": b1_launches, "seconds": seconds, "card": smi})
    return {"seconds": seconds, "b1_launches": b1_launches}


# ------------------------------------------------------------ captured_trunks
def release_graphs(torch) -> None:
    """Free the graphs of the metrics a phase dropped, and their pools' memory.

    A metric refers back to itself through its wrapped ``update``, so it goes
    only when Python's collector runs, and with it its graphs and its trunks'
    (a pool of InceptionV3 at batch 200 holds 3.5 GB).
    """
    gc.collect()
    torch.cuda.empty_cache()


def _max_abs_diff(a, b) -> float:
    """The largest absolute difference between two trees of tensors (inf where shapes differ)."""
    if isinstance(a, dict):
        return max((_max_abs_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        return max((_max_abs_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def _trunk_route(torch, np, make, calls, counters: dict, compiled: bool, replays: bool) -> dict:
    """One route of a trunk metric: built by ``make(auto_compile)``, fed ``calls``, computed once.

    ``calls`` are ``(signature, args, kwargs)``; where ``replays`` (a class the JAX runtime compiles), from its
    third call a signature's update is a graph replay on the compiled route, run under
    ``torch.cuda.set_sync_debug_mode("error")``. The steady part of the stream starts at the first call that
    sees its signature a third time (after a synchronize). Returns the states, the value, the kernels'
    launches, the host ms of each update by kind, the steady seconds and the graphs with their pools' bytes.
    """
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    metric = make(compiled)
    on_card = metric.device.type == "cuda"
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    seen, host = collections.Counter(), {"first": [], "capture": [], "replay": [], "eager": []}
    t0 = time.perf_counter()
    t_steady, steady_calls = None, 0
    for key, args, kwargs in calls:
        seen[key] += 1
        if seen[key] >= 3:
            if t_steady is None:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            steady_calls += 1
        g0 = compile_mod.stats()
        replay = compiled and replays and seen[key] >= 3 and on_card
        h0 = time.perf_counter()
        with _sync_guard(torch, replay):
            metric.update(*args, **kwargs)
        ms = (time.perf_counter() - h0) * 1e3
        g1 = compile_mod.stats()
        kind = ("capture" if g1["captured"] > g0["captured"] else "replay" if g1["replayed"] > g0["replayed"]
                else "first" if seen[key] == 1 else "eager")
        check(not replay or kind == "replay", f"{type(metric).__name__}: call {seen[key]} of a signature ran {kind}")
        host[kind].append(ms)
    torch.cuda.synchronize()
    t_updates = time.perf_counter() - t0
    steady_seconds = None if t_steady is None else time.perf_counter() - t_steady
    np.random.seed(0)  # IS and KID draw their subsets from numpy's global generator
    value = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: int(c) for name, c in counters.items()}  # BERTScore's encoder runs in compute
    trunk = next((m for m in metric.modules() if isinstance(m, compile_mod.CapturedForward)), None)
    graphs = metric.__dict__.get("_auto_update_fn", {})
    return {
        "metric": metric, "value": value, "launches": launches, "states": _states(metric),
        "updates_seconds": t_updates, "seconds": seconds, "steady_seconds": steady_seconds,
        "steady_calls": steady_calls,
        "host_ms": {k: {"calls": len(v), "median": statistics.median(v)} for k, v in host.items() if v},
        "engaged": _engaged(metric), "disabled": metric._auto_disabled, "reason": metric._auto_disabled_reason,
        "replays_by_signature": sorted(metric._auto_sigs.values()),
        "metric_graphs": len(graphs),
        "metric_pool_bytes": compile_mod.pool_bytes(metric.__dict__.get("_graph_pool")),
        "trunk": trunk is not None, "trunk_graphs": 0 if trunk is None else len(trunk.graphs),
        "trunk_pool_bytes": 0 if trunk is None else compile_mod.pool_bytes(trunk.pool),
        "trunk_eager_signatures": 0 if trunk is None else len(trunk.eager),
    }


CAPTURED_TRUNKS = {"fid_batch": 200, "fid_pairs": 10, "lpips_pairs": 50, "lpips_side": 256, "clip": CLIP_B16,
                   "clip_batch": 64, "bert_pairs": 100, "bert_width": 128, "srmr_batch": 16, "srmr_samples": 128_000,
                   "bert_memory": (100, 512)}


def phase_captured_trunks(torch, np, ce, lh, ka, kb, dev, gen, seed: int, smi: str, npz_folder: str,
                          sizes=CAPTURED_TRUNKS) -> dict:
    """The trunk metrics streamed by default (compiled where the JAX runtime compiles) and with ``auto_compile=False``.

    FID (InceptionV3 2048, batches of 200), IS and KID with ``cat_state_capacity=4000``, LPIPS (alex, 50 pairs of
    256x256), CLIPScore (ViT-B/16, 64 pairs, two caption lists alternating), BERTScore (bert-base, 3 x 100 pairs)
    and SRMR (16 x 8 s at 16 kHz): the routing of the JAX runtime, states and ``compute()`` bit for bit between the
    routes, the kernels' launches equal between the routes and per forward, replays under the sync guard, graphs and
    pool bytes, host ms an update and the rates on each route.
    """
    from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        InceptionScore,
        KernelInceptionDistance,
        LearnedPerceptualImagePatchSimilarity,
    )
    from torchmetrics_tpu_torch.multimodal import CLIPScore
    from torchmetrics_tpu_torch.text import BERTScore
    from torchmetrics_tpu_torch.text._bert_encoder import BertEncoderExtractor

    t_phase = time.perf_counter()
    counters = {name: fn.launches for name, fn in (("B2a", ce.matmul_bias_relu), ("B2b", ce.bias_relu_),
                                                   ("B3", lh.lpips_head), ("B4", ka.attention),
                                                   ("B5", ka.layernorm_residual), ("S1", kb.biquad_bank))}
    rng = np.random.default_rng([seed, 49])
    fb, npairs, lp, side, cb = (sizes[k] for k in ("fid_batch", "fid_pairs", "lpips_pairs", "lpips_side", "clip_batch"))
    bp, bw, sb = sizes["bert_pairs"], sizes["bert_width"], sizes["srmr_batch"]
    inception = inception_npz(torch, np, seed, npz_folder, dev, gen)
    clip_b = clip_npz(torch, np, sizes["clip"], seed + 2, npz_folder, dev)
    bert = bert_base_npz(torch, np, seed, npz_folder)
    imgs = [torch.randint(0, 256, (fb, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
            for _ in range(2 * npairs)]
    pairs = [(torch.rand((lp, 3, side, side), generator=gen, device=dev) * 2 - 1) for _ in range(20)]
    clip_side = sizes["clip"]["image_size"]
    clip_imgs = [natural_images(torch, dev, gen, cb, clip_side, clip_side).float() / 255 for _ in range(6)]
    caption_lists = [coco_captions(np, rng, cb), coco_captions(np, rng, cb)]
    texts = token_corpus(np, rng, pairs=3 * bp, width=bw, min_len=10, max_len=min(100, bw), mean_len=min(40.0, bw / 3),
                         vocab=BERT_BASE["vocab_size"])
    audio = reverb_utterances(torch, dev, gen, 4 * sb, sizes["srmr_samples"], 16_000)
    sl = lambda enc, a: {k: v[a:a + bp] for k, v in enc.items()}  # noqa: E731

    cases = {
        # name: (make(auto_compile), calls, expected route, units, kernels and launches a forward, forwards)
        "fid": (lambda auto: FrechetInceptionDistance(feature=2048, weights_path=inception, auto_compile=auto),
                [(r, (imgs[2 * i + r],), {"real": bool(1 - r)}) for i in range(npairs) for r in (0, 1)],
                "compiled", 2 * npairs * fb, {"B2a": 40, "B2b": 54}, 2 * npairs),
        "is_capacity": (lambda auto: InceptionScore(weights_path=inception, cat_state_capacity=2 * npairs * fb,
                                                    auto_compile=auto),
                        [(0, (imgs[i],), {}) for i in range(npairs)], "compiled", npairs * fb,
                        {"B2a": 40, "B2b": 54}, npairs),
        "kid_capacity": (lambda auto: KernelInceptionDistance(weights_path=inception, cat_state_capacity=2 * npairs * fb,
                                                              subsets=100, subset_size=npairs * fb // 2,
                                                              auto_compile=auto),
                         [(r, (imgs[2 * i + r],), {"real": bool(1 - r)}) for i in range(npairs // 2) for r in (0, 1)],
                         "compiled", npairs * fb, {"B2a": 40, "B2b": 54}, npairs),
        "lpips_alex": (lambda auto: LearnedPerceptualImagePatchSimilarity(net_type="alex", auto_compile=auto),
                       [(0, (pairs[2 * i], pairs[2 * i + 1]), {}) for i in range(10)], "compiled", 10 * lp,
                       {"B3": 5}, 10),
        # two caption lists alternating, so each signature is seen a third time: a replay
        "clipscore_vit_b16": (lambda auto: CLIPScore(weights_path=clip_b, tokenizer=ClipTokenizer(), auto_compile=auto),
                              [(i % 2, (clip_imgs[i], caption_lists[i % 2]), {}) for i in range(6)], "compiled",
                              6 * cb, {}, 6),
        "bertscore": (lambda auto: BERTScore(weights_path=bert, max_length=bw, auto_compile=auto),
                      [(0, (sl(texts[0], bp * i), sl(texts[1], bp * i)), {}) for i in range(3)], "eager", 3 * bp,
                      {"B4": 12, "B5": 24}, 2),
        "srmr": (lambda auto: SpeechReverberationModulationEnergyRatio(16_000, auto_compile=auto),
                 [(0, (audio[sb * i:sb * (i + 1)],), {}) for i in range(4)], "compiled", 4 * sb, {"S1": 2}, 4),
    }
    out = {}
    for name, (make, calls, route, units, per_forward, forwards) in cases.items():
        compiled, eager = (_trunk_route(torch, np, make, calls, counters, flag, route == "compiled")
                           for flag in (True, False))
        states_equal = _same(torch, compiled["states"], eager["states"])
        value_equal = _same(torch, compiled["value"], eager["value"])
        diffs = {"states": _max_abs_diff(compiled["states"], eager["states"]),
                 "value": _max_abs_diff(compiled["value"], eager["value"])}
        # a kernel on the CPU is its plain version, launching nothing
        want = {k: per_forward.get(k, 0) * forwards * (dev.type == "cuda") for k in counters}
        line = {
            "phase": "captured_trunks", "metric": name, "expected_route": route, "units": units,
            "states_bit_equal": states_equal, "value_bit_equal": value_equal, "max_abs_diff": diffs,
            "launches": {"compiled": compiled["launches"], "eager": eager["launches"], "expected": want},
            "routing": {k: compiled[k] for k in ("engaged", "disabled", "reason", "replays_by_signature")},
            "graphs": {"metric": compiled["metric_graphs"], "metric_pool_bytes": compiled["metric_pool_bytes"],
                       "trunk": compiled["trunk_graphs"], "trunk_pool_bytes": compiled["trunk_pool_bytes"],
                       "eager_route_trunk": eager["trunk_graphs"], "eager_route_trunk_pool_bytes": eager["trunk_pool_bytes"],
                       "trunk_eager_signatures": {"compiled": compiled["trunk_eager_signatures"],
                                                  "eager": eager["trunk_eager_signatures"]}},
            "host_ms_an_update": {"compiled": compiled["host_ms"], "eager": eager["host_ms"]},
            "seconds": {"compiled": compiled["seconds"], "eager": eager["seconds"]},
            "units_per_s": {"compiled": units / compiled["seconds"], "eager": units / eager["seconds"]},
            # from the first call of a signature's third sighting to the end of the updates, no compute
            "steady_units_per_s": None if route != "compiled" else {
                r["name"]: None if not r["steady_calls"] else units / len(calls) * r["steady_calls"] / r["steady_seconds"]
                for r in ({"name": "compiled", **compiled}, {"name": "eager", **eager})},
            "card": smi,
        }
        emit(line)
        check(states_equal and value_equal, f"{name}: the compiled route differs from auto_compile=False: {diffs}")
        check(compiled["launches"] == eager["launches"] == want,
              f"{name}: launches {compiled['launches']} compiled, {eager['launches']} eager, {want} expected")
        if route == "compiled":
            check(compiled["engaged"] and compiled["reason"] is None and compiled["metric_graphs"] > 0
                  and all(v > 0 for v in compiled["replays_by_signature"]),
                  f"{name}: not compiled: {line['routing']}, {compiled['metric_graphs']} graphs")
            # the metric's graph holds the only copy of its trunk: a signature's first, eager call runs it inline
            check(compiled["trunk_graphs"] == 0, f"{name}: {compiled['trunk_graphs']} trunk graphs beside the metric's")
        else:
            check(compiled["disabled"] and compiled["metric_graphs"] == 0, f"{name}: compiled, expected eager")
        check(not eager["engaged"] and eager["metric_graphs"] == 0, f"{name}: auto_compile=False compiled")
        # eagerly, a trunk that meets a shape again captures it (every trunk here repeats its shapes)
        check(not eager["trunk"] or dev.type != "cuda" or eager["trunk_graphs"] > 0,
              f"{name}: the trunk captured nothing on auto_compile=False")
        out[name] = line
        del compiled, eager
        release_graphs(torch)

    # memory of one trunk forward's graph: BERT-base at (100, 512) (ViT-L/14's is in phase 46)
    encoder = BertEncoderExtractor(bert)
    ids = torch.randint(1000, BERT_BASE["vocab_size"], sizes["bert_memory"], generator=gen, device=dev)
    mask = torch.ones_like(ids)
    runs = [encoder(ids, mask) for _ in range(3)]  # eager, captured, replayed
    check(all(torch.equal(runs[0], r) for r in runs) and len({r.data_ptr() for r in runs}) == 3
          and len(encoder.captured.graphs) == (dev.type == "cuda"), "BERT-base: eager, capture and replay")
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    memory = {"bert_base_" + "x".join(map(str, sizes["bert_memory"])): {
        "graphs": len(encoder.captured.graphs), "pool_bytes": compile_mod.pool_bytes(encoder.captured.pool)}}
    del encoder, runs
    fid_line = out["fid"]["graphs"]
    memory["inception_v3_bf16_batch200"] = {"trunk_pool_bytes": fid_line["eager_route_trunk_pool_bytes"],
                                            "metric_pool_bytes": fid_line["metric_pool_bytes"]}
    # a trunk's graphs are dropped past this
    memory["trunk_pool_bound_bytes"] = compile_mod._pool_bound(dev) if dev.type == "cuda" else None
    seconds = time.perf_counter() - t_phase
    emit({"phase": "captured_trunks", "seconds": seconds, "memory": memory, "graphs": compile_mod.stats(), "card": smi})
    both = [line["launches"][route] for line in out.values() for route in ("compiled", "eager")]
    return {"seconds": seconds, "launches": {k: sum(d[k] for d in both) for k in counters}}


class _sync_guard:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block (when ``on``): a host sync in it raises."""

    def __init__(self, torch, on: bool = True):
        self.torch, self.on = torch, on

    def __enter__(self):
        if self.on:
            self.mode = self.torch.cuda.get_sync_debug_mode()
            self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.set_sync_debug_mode(self.mode)


# ------------------------------------------------------------------ stream_pool
# phase 52: a MulticlassConfusionMatrix pool at ImageNet's 1,000 classes, 128 tenants growing to 256 (one
# doubling), micro-batches of 64 tenants x 1,024 labels, 50,000 labels a tenant (49 rows each: 196 steps, the
# last row of each tenant padded with void labels); the stat-score members of classification_collection as a
# 64-tenant collection pool
STREAM_SIZES = {"classes": 1000, "tenants": 256, "capacity": 128, "lanes": 64, "rows": 1024,
                "labels_per_tenant": 50_000, "collection_tenants": 64, "collection_batch": 256,
                "collection_steps": 4, "timed_steps": 24}
STREAM_TWINS = 8  # tenants also streamed into eager twins


def stream_pool_labels(torch, dev, gen, tenants: int, chunks: int, rows: int, classes: int, per_tenant: int):
    """``(tenants, chunks, rows)`` int64 predicted and true labels, 76% right; labels past ``per_tenant`` are void (-1)."""
    shape = (tenants, chunks, rows)
    target = torch.randint(0, classes, shape, generator=gen, device=dev)
    right = torch.rand(shape, generator=gen, device=dev) < 0.76
    preds = torch.where(right, target, torch.randint(0, classes, shape, generator=gen, device=dev))
    void = (torch.arange(chunks * rows, device=dev) >= per_tenant).reshape(chunks, rows)
    target[:, void] = -1
    preds[:, void] = -1
    return preds, target


def phase_stream_pool(torch, np, kernel, dev, gen, smi: str, sizes=None) -> dict:
    """Multi-tenant stream pools (``_streams``) on the card, through ``to_stream_pool``.

    1. A ``MulticlassConfusionMatrix(num_classes=1000, ignore_index=-1)`` pool: ``warm_start`` at capacity 128,
       128 tenants, then 128 more attached mid-round (one doubling, the next step captured again), 196 vmapped
       micro-batches of 64 tenants x 1,024 labels with kernel B1 counting each micro-batch's 64 matrices in one
       launch; resets and detach/attach churn between rounds (a detached slot's row is padding, -1, until its slot
       is attached again); one row with a label outside [0, C) (the class has no traced flags: it is counted as
       its eager twin without ``validate_args`` counts it, i.e. not at all). Every tenant's matrix bit for bit
       against a numpy bincount of the rows it took, 8 tenants against eager twins, B1's lane-batched launches
       equal to the steps, the lane-batched kernel against its plain version, a ``StreamSnapshotManager``
       journaling every step and its ``restore_stream`` of two tenants and ``restore_latest``, bit for bit.
    2. The stat-score members of ``classification_collection`` (micro accuracy, macro precision, recall and
       F1 at 1,000 classes, one compute group) as a 64-tenant collection pool against eager twin collections.
    3. Host and device ms per step, ``compute_all`` ms, B1's lane-batched ``queued_ms`` at (64, 1024, 1000)
       beside its bound, its plain version and ``bincount``, and the lanes' gather and scatter.
    """
    tp = importlib.import_module("torchmetrics_tpu_torch")
    streams = importlib.import_module("torchmetrics_tpu_torch._streams")
    res = importlib.import_module("torchmetrics_tpu_torch._resilience")
    compiled = importlib.import_module("torchmetrics_tpu_torch._compile")
    sizes = dict(STREAM_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    c, n_ten, cap0, lanes, rows = (sizes[k] for k in ("classes", "tenants", "capacity", "lanes", "rows"))
    chunks = -(-sizes["labels_per_tenant"] // rows)
    per_round = n_ten // lanes
    preds, target = stream_pool_labels(torch, dev, gen, n_ten, chunks, rows, c, sizes["labels_per_tenant"])
    odd_tenant, odd_chunk = 7, 3
    target[odd_tenant, odd_chunk, 0] = c  # outside [0, C)
    host_p, host_t = preds.cpu().numpy(), target.cpu().numpy()
    lanes_k, b1 = kernel.confusion_matrix_lanes.launches, kernel.confusion_matrix_cuda.launches
    b1_0 = int(b1)

    def make(**kw):
        return tp.classification.MulticlassConfusionMatrix(num_classes=c, ignore_index=-1, device=dev, **kw)

    # the lifecycle between rounds: (round, action, slot); an attach must hand out the slot detached before
    c1, c3 = chunks // 5, chunks // 2
    gap = max(1, chunks // 8)
    churn = {c1: [("reset", 3), ("detach", n_ten // 2 + 2)], c1 + gap: [("attach", n_ten // 2 + 2)],
             c3: [("reset", ((3 * n_ten) // 4 + 8) % n_ten), ("detach", 5)], c3 + gap: [("attach", 5)],
             (3 * chunks) // 4: [("reset", n_ten // 4)]}
    applied = {}  # slot -> the chunks it took since its last attach or reset
    pool = make().to_stream_pool(capacity=cap0)
    with tempfile.TemporaryDirectory() as folder:
        mgr = streams.StreamSnapshotManager(
            pool, folder, res.SnapshotPolicy(every_n_updates=10**6, journal_max_entries=10**6, async_write=False))
        for _ in range(cap0):
            applied[pool.attach()] = []
        lanes_k.reset()  # the main path: counted from here
        warm = pool.warm_start(np.arange(lanes), preds[:lanes, 0], target[:lanes, 0])
        check(warm["stream_step"] == "compiled", f"warm_start: {warm}")
        steps, stream_host_ms = 0, []
        t0 = time.perf_counter()
        for r in range(chunks):
            for action, slot in churn.get(r, ()):
                if action == "reset":
                    pool.reset(slot)
                elif action == "detach":
                    pool.detach(slot)
                else:
                    check(pool.attach() == slot, f"attach did not recycle slot {slot}")
                applied[slot] = []
            for s in range(per_round):
                if r == 0 and s * lanes == cap0:
                    for _ in range(n_ten - cap0):  # the 129th attach doubles the capacity
                        applied[pool.attach()] = []
                    check(pool.capacity == 2 * cap0 and pool.growths == 1, f"capacity {pool.capacity}")
                active = set(pool.active_streams)
                ids = np.array([sl if sl in active else -1 for sl in range(s * lanes, (s + 1) * lanes)], np.int64)
                h0 = time.perf_counter()
                pool.update(ids, preds[s * lanes:(s + 1) * lanes, r], target[s * lanes:(s + 1) * lanes, r])
                stream_host_ms.append((time.perf_counter() - h0) * 1e3)
                for sl in ids[ids >= 0].tolist():
                    applied[sl].append(r)
                steps += 1
        if on_card:
            torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        lanes_launches = int(lanes_k)  # the main path: read here
        mgr.simulate_preemption()
        t_all = time.perf_counter()
        got = pool.compute_all()
        if on_card:
            torch.cuda.synchronize()
        compute_all_ms = (time.perf_counter() - t_all) * 1e3
        check(sorted(got) == list(range(n_ten)), "compute_all's tenants")
        check(steps == chunks * per_round, f"{steps} steps")
        check(lanes_launches == (steps + 1 if on_card else 0),
              f"B1 lane-batched launches {lanes_launches} for {steps} steps and one warm_start")
        check(pool.capture_failures == {}, f"captures failed: {pool.capture_failures}")
        if on_card:
            check(all(isinstance(e, compiled.CapturedStep) for e in pool._step_fns.values()),
                  "a step of the card's pool is not a CUDA graph")
        check(pool.pending_violations(odd_tenant) == 0 and pool.stream_update_count(odd_tenant) == len(applied[odd_tenant]),
              "the row with a label outside [0, C) was dropped")
        mismatched = []
        for sl in range(n_ten):
            t = host_t[sl, applied[sl]].reshape(-1)
            p = host_p[sl, applied[sl]].reshape(-1)
            keep = (t >= 0) & (t < c) & (p >= 0) & (p < c)
            ref = np.bincount(t[keep] * c + p[keep], minlength=c * c).reshape(c, c)
            if not np.array_equal(got[sl].cpu().numpy(), ref):
                mismatched.append(sl)
        check(not mismatched, f"tenants whose matrix != the numpy bincount of their rows: {mismatched[:10]}")
        twin_slots = [0, 3, 5, odd_tenant, n_ten // 4, n_ten // 2 + 2, ((3 * n_ten) // 4 + 8) % n_ten, n_ten - 1][:STREAM_TWINS]
        for sl in twin_slots:
            eager = make(validate_args=False)
            for r in applied[sl]:
                eager.update(preds[sl, r], target[sl, r])
            check(torch.equal(eager.compute(), got[sl]), f"tenant {sl} != its eager twin")
        # restores from the journal: two tenants into a fresh pool, then the whole pool into another
        restored = {}
        fresh = make().to_stream_pool(capacity=n_ten)
        for _ in range(n_ten):
            fresh.attach()
        mgr2 = streams.StreamSnapshotManager(fresh, folder, res.SnapshotPolicy(async_write=False))
        for sl in (odd_tenant, n_ten // 2 + 2):
            report = mgr2.restore_stream(sl)
            check(torch.equal(fresh.compute(sl), got[sl]) and report.replayed >= 1 and not report.fell_back,
                  f"restore_stream({sl}): {report}")
            restored[sl] = {"generation": report.generation, "replayed": report.replayed}
        mgr2.close()
        whole = make().to_stream_pool(capacity=cap0)
        mgr3 = streams.StreamSnapshotManager(whole, folder, res.SnapshotPolicy(async_write=False))
        report = mgr3.restore_latest()
        mgr3.close()
        again = whole.compute_all()
        check(sorted(again) == sorted(got) and all(torch.equal(again[sl], got[sl]) for sl in got),
              f"restore_latest: {report}")
        restored["latest"] = {"generation": report.generation, "replayed": report.replayed, "capacity": whole.capacity}
        del fresh, whole, again

    # the lane-batched kernel against its plain version at the pool's shape, and its times
    lane_p = preds[:lanes, 0].contiguous()
    lane_t = target[:lanes, 0].contiguous()
    lane_p2, lane_t2 = preds[:lanes, chunks - 1].contiguous(), target[:lanes, chunks - 1].contiguous()  # void tails
    lane_err = 0.0
    for p, t in ((lane_p, lane_t), (lane_p2, lane_t2)):
        valid = t != -1
        got_lanes = kernel.confusion_matrix_lanes(p, t, c, valid)
        want_lanes = kernel.confusion_matrix_lanes_plain(p, t, c, valid)
        check(torch.equal(got_lanes, want_lanes), "the lane-batched kernel != its plain version")
        lane_err = max(lane_err, float((got_lanes.double() - want_lanes.double()).abs().max()))
    timing = {}
    if on_card:
        valid = lane_t != -1
        buf = torch.zeros((lanes, c, c), dtype=torch.int32, device=dev)
        fused = ((lane_t * c + lane_p) + torch.arange(lanes, device=dev)[:, None] * (c * c))[valid]
        label_bytes = lane_p.numel() * (2 * lane_p.element_size() + valid.element_size())
        states = pool._states[""]["confmat"]
        idx = torch.arange(lanes, device=dev)
        gathered = states.index_select(0, idx)
        timing = {
            "ms": queued_ms(torch, lambda: kernel.confusion_matrix_lanes(lane_p, lane_t, c, valid, out=buf), reps=50),
            "call_ms": median_ms(torch, lambda: kernel.confusion_matrix_lanes(lane_p, lane_t, c, valid, out=buf), reps=50),
            "plain_ms": median_ms(torch, lambda: kernel.confusion_matrix_lanes_plain(lane_p, lane_t, c, valid), reps=10),
            "library_ms": median_ms(torch, lambda: torch.bincount(fused, minlength=lanes * c * c), reps=20),
            "bound_ms": label_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # each step gathers the 64 lanes' (C, C) int32 rows and writes them back: 2 x 256 MB at C = 1000
            "gather_ms": median_ms(torch, lambda: states.index_select(0, idx), reps=20),
            "scatter_ms": median_ms(torch, lambda: states.index_copy_(0, idx, gathered), reps=20),
            "gather_scatter_bound_ms": 4 * gathered.numel() * gathered.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        # steady steps of the captured pool: host ms to return, device ms between events around each step
        host_ms, events = [], []
        for k in range(sizes["timed_steps"]):
            s, r = k % per_round, k % chunks
            ids = np.arange(s * lanes, (s + 1) * lanes)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            pool.update(ids, preds[s * lanes:(s + 1) * lanes, r], target[s * lanes:(s + 1) * lanes, r])
            end.record()
            host_ms.append((time.perf_counter() - h0) * 1e3)
            events.append((start, end))
        torch.cuda.synchronize()
        timing["host_ms_per_step"] = statistics.median(host_ms)
        timing["device_ms_per_step"] = statistics.median(s.elapsed_time(e) for s, e in events)
    del pool, got

    # ------------------------------------------------ 2. the collection pool: the stat-score members
    n_col, batch, col_steps = sizes["collection_tenants"], sizes["collection_batch"], sizes["collection_steps"]

    def members():
        return {
            "acc": tp.MulticlassAccuracy(num_classes=c, average="micro", device=dev),
            "precision": tp.MulticlassPrecision(num_classes=c, device=dev),
            "recall": tp.MulticlassRecall(num_classes=c, device=dev),
            "f1": tp.MulticlassF1Score(num_classes=c, device=dev),
        }

    col_pool = tp.MetricCollection(members()).to_stream_pool(capacity=n_col)
    slots = [col_pool.attach() for _ in range(n_col)]
    twins = [tp.MetricCollection(members()) for _ in range(n_col)]
    col_host_ms = []
    for _ in range(col_steps):
        logits = torch.randn((n_col, batch, c), generator=gen, device=dev)
        labels = torch.randint(0, c, (n_col, batch), generator=gen, device=dev)
        hit = torch.rand((n_col, batch), generator=gen, device=dev) < 0.76
        logits.scatter_add_(2, labels[..., None], 10.0 * hit[..., None].float())
        h0 = time.perf_counter()
        col_pool.update(slots, logits, labels)
        col_host_ms.append((time.perf_counter() - h0) * 1e3)
        for i, twin in enumerate(twins):
            twin.update(logits[i], labels[i])
    col_got = col_pool.compute_all()
    check(len(col_pool._units) == 1 and sorted(col_pool._units[0].members[k][0] for k in range(4))
          == ["acc", "f1", "precision", "recall"], "the stat-score members share one compute group's rows")
    col_err = 0.0
    for i, sl in enumerate(slots):
        want = twins[i].compute()
        check(float(col_got[sl]["acc"]) == float(want["acc"]), f"tenant {sl}: micro accuracy != its eager twin")
        for name in ("precision", "recall", "f1"):
            err = abs(float(col_got[sl][name]) - float(want[name]))
            col_err = max(col_err, err)
            check(err <= COLLECTION_RATIO_ATOL, f"tenant {sl}: macro {name} vs its eager twin: {err}")
    del col_pool, twins

    b1_launches = int(b1) - b1_0
    seconds = time.perf_counter() - t_phase
    out = {
        "phase": "stream_pool", "classes": c, "tenants": n_ten, "capacity": [cap0, 2 * cap0], "growths": 1,
        "lanes": lanes, "rows": rows, "labels_per_tenant": sizes["labels_per_tenant"], "steps": steps,
        "warm_start": warm, "lanes_launches": lanes_launches, "b1_unbatched_launches": b1_launches,
        "restored": restored, "max_abs_err": lane_err, "eager_twins": twin_slots,
        "stream_seconds": stream_s, "stream_host_ms_median": statistics.median(stream_host_ms),
        "compute_all_ms": compute_all_ms, "timing": timing,
        "collection": {"tenants": n_col, "batch": batch, "steps": col_steps, "max_ratio_err": col_err,
                       "host_ms_per_step": statistics.median(col_host_ms)},
        "tolerance": {"counts": "exact", "micro_accuracy": "exact", "macro_ratios": COLLECTION_RATIO_ATOL},
        "seconds": seconds, "card": smi,
    }
    emit(out)
    return out


# ------------------------------------------------------------------ trunk_pools
# phase 53: the trunk metrics in stream pools, each trunk kernel once a micro-batch across its lanes. FID at 2048
# features on InceptionV3 (16 tenants, capacity 16, micro-batches of 8 lanes x 25 CIFAR-10-sized images: the batch of
# 200 that image_timing times B2a and B2b at, real and fake alternating), LPIPS alex (8 lanes x 8 pairs of 256x256),
# CLIPScore ViT-B/16 (8 lanes x 8 images, one caption list a micro-batch, shared by its lanes), SRMR (8 lanes x 2
# reverberant 8 s utterances at 16 kHz, srmr_reverb's configuration)
TRUNK_POOL_SIZES = {"tenants": 16, "lanes": 8, "fid_images": 25, "fid_rounds": 4, "lpips_pairs": 8, "lpips_side": 256,
                    "lpips_rounds": 2, "clip": CLIP_B16, "clip_images": 8, "clip_rounds": 2, "srmr_utterances": 2,
                    "srmr_samples": 128_000, "srmr_rounds": 1, "s1_plain_samples": 4_000, "timed_steps": 8}
# a pooled tenant against its eager twin, by relative norm of each state and of the value. FID: the pool's spatial
# convs run cuDNN at 200 images, the twin's at 25, and cuDNN picks its algorithm by the batch; with calibrated
# BatchNorm a random bf16 InceptionV3 is chaotic, so one rounding apart grows as TRUNK_BF16_RTOL says. LPIPS: the same
# for alex's five bf16 layers, and B3's cluster plan depends on the rows. CLIPScore: cuBLAS sums a batched product of
# the lanes in another order than one lane's. SRMR: S1 is the same recurrence a row; cuFFT's plan depends on the rows.
TRUNK_POOL_RTOL = {"fid": TRUNK_BF16_RTOL, "lpips": 1e-2, "clip": 1e-4, "srmr": 1e-4}


def _tensor_rel(torch, got, want) -> float:
    num = float(torch.linalg.vector_norm((got.double() - want.double()).flatten()))
    den = float(torch.linalg.vector_norm(want.double().flatten()))
    return num / den if den else num


def _under_vmap(torch, fn, *lanes, in_dims=0):
    from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback

    with torch.no_grad(), _no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*lanes)


def trunk_lane_kernels(torch, np, ce, lh, ka, kb, dev, gen, calls, taps, sizes) -> dict:
    """Each trunk kernel's lane-batched launch at the pooled main path's folded shapes.

    Under ``torch.func.vmap`` (fallback off) each wrapper runs its custom op's rule: the lanes folded into one
    launch. Held against the plain version (the tolerances of the single-launch phases) and against a loop of one
    launch a lane (bit for bit, but B3, whose cluster plan depends on the rows: ``HEAD_RTOL``), and timed: the
    folded launch's ``queued_ms`` beside its bound, the loop's, the plain version's and the library call's, summed
    over one forward's launches. ``calls``: one lane's InceptionV3 convs (25 images); ``taps``: one lane's alex taps.
    """
    import torch.nn.functional as F

    lanes = sizes["lanes"]
    on_card = dev.type == "cuda"

    def like_loop(got, loop, rtol):
        """The folded launch against a launch a lane: on the card bit for bit (a kernel's rows or heads do not
        depend on the batch, but B3's cluster plan); the CPU's plain versions (a CPU rehearsal) sum BLAS tiles
        by the batch, so there within ``rtol`` of the output's scale."""
        if on_card:
            return torch.equal(got, loop)
        return float((got.float() - loop.float()).abs().max()) <= rtol * float(loop.float().abs().max())

    meta = lambda shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)  # noqa: E731
    rows = {k: [] for k in ("B2a", "B2b", "B3", "B4", "B5", "S1")}

    def timed(folded, loop, plain, library, reps=20, plain_reps=5):
        if not on_card:
            return {}
        return {"ms": queued_ms(torch, folded, reps=reps), "loop_ms": queued_ms(torch, loop, reps=reps, launches=lanes),
                "plain_ms": median_ms(torch, plain, reps=plain_reps, warmup=1),
                "library_ms": None if library is None else median_ms(torch, library, reps=reps)}

    # B2a and B2b: each conv of a forward at 8 lanes x 25 images, through conv_bias_act's rule
    for call, count in collections.Counter(calls).items():
        (n, cin, h, w), wshape, stride, padding, _ = call
        xs = torch.randn((lanes, n, h, w, cin), generator=gen, device=dev).relu_().bfloat16().permute(0, 1, 4, 2, 3)
        weight = (torch.randn(wshape, generator=gen, device=dev) / (cin * wshape[2] * wshape[3]) ** 0.5).bfloat16()
        bias = (0.1 * torch.randn(wshape[0], generator=gen, device=dev)).bfloat16()
        before = (int(ce.matmul_bias_relu.launches), int(ce.bias_relu_.launches))
        got = _under_vmap(torch, lambda x: ce.conv_bias_act(x, weight, bias, stride, padding), xs)
        launched = (int(ce.matmul_bias_relu.launches) - before[0], int(ce.bias_relu_.launches) - before[1])
        loop = torch.stack([ce.conv_bias_act(x, weight, bias, stride, padding) for x in xs])
        if is_pointwise(call):
            m, k, nout = lanes * n * h * w, cin, wshape[0]
            x2d = xs.permute(0, 1, 3, 4, 2).reshape(m, k)
            w2d = weight.reshape(nout, k)
            ref = ce.matmul_bias_relu_plain(x2d, w2d, bias).reshape(lanes, n, h, w, nout).permute(0, 1, 4, 2, 3)
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            check(bool((err <= GEMM_BF16_ULP * ref.float().abs() + GEMM_F32_RTOL * scale).all()),
                  f"B2a across lanes {call}: max abs err {float(err.max())} against its plain version")
            check(like_loop(got, loop, GEMM_BF16_ULP), f"B2a across lanes {call}: differs from a launch a lane")
            check(launched == ((1, 0) if on_card else (0, 0)), f"B2a across lanes {call}: launches {launched}")
            per_lane = x2d.reshape(lanes, n * h * w, k)
            bound, by = bound_ms(ce.conv_bias_act_cost(meta((lanes * n, cin, h, w)), meta(wshape), meta((nout,))),
                                 BF16_FLOPS_PER_S)
            rows["B2a"].append({"shape": [m, k, nout], "count": count, "max_abs_err": float(err.max()),
                                "bound_ms": bound, "bound_by": by, **timed(
                lambda: ce.matmul_bias_relu(x2d, w2d, bias), lambda: [ce.matmul_bias_relu(p, w2d, bias) for p in per_lane],
                lambda: ce.matmul_bias_relu_plain(x2d, w2d, bias), lambda: torch.addmm(bias, x2d, w2d.T).relu_())})
        else:
            # the library conv runs at 200 images here and at 25 in the loop: cuDNN may pick another algorithm, so
            # B2b is held on its own, on the folded conv's output, against its plain version and a launch a lane
            check(launched == ((0, 1) if on_card else (0, 0)), f"B2b across lanes {call}: launches {launched}")
            y = F.conv2d(xs.flatten(0, 1), weight, None, stride, padding).contiguous(memory_format=torch.channels_last)
            y2d = y.permute(0, 2, 3, 1).reshape(-1, wshape[0])
            ref = ce.bias_relu_plain(y2d, bias)
            folded = ce.bias_relu_(y2d.clone(), bias)
            per_lane = y2d.reshape(lanes, -1, wshape[0])
            looped = torch.cat([ce.bias_relu_(p.clone(), bias) for p in per_lane])
            err = float((folded.float() - ref.float()).abs().max())
            check(torch.equal(folded, ref) and torch.equal(looped, folded),
                  f"B2b across lanes {call}: max abs err {err} against its plain version, or the loop differs")
            work = y2d.clone()
            bound, by = bound_ms(ce.bias_relu_cost(y2d, bias), F32_FLOPS_PER_S)
            rows["B2b"].append({"shape": list(y2d.shape), "count": count, "max_abs_err": err, "bound_ms": bound,
                                "bound_by": by, "conv_vs_loop_rel": _tensor_rel(torch, got, loop), **timed(
                lambda: ce.bias_relu_(work, bias), lambda: [ce.bias_relu_(p, bias) for p in work.view(lanes, -1, wshape[0])],
                lambda: ce.bias_relu_plain(y2d, bias), lambda: torch.add(y2d, bias).relu_())})

    # B3: alex's five taps at 8 lanes x 8 pairs, bf16 maps as the trunk hands them over
    for shape in taps:
        f0 = torch.randn((lanes, *shape), generator=gen, device=dev).relu_().bfloat16()
        f1 = (f0.float() + 0.3 * torch.randn((lanes, *shape), generator=gen, device=dev)).relu_().bfloat16()
        wt = torch.rand(shape[-1], generator=gen, device=dev)
        before = int(lh.lpips_head.launches)
        got = _under_vmap(torch, lambda a, b: lh.lpips_head(a, b, wt), f0, f1)
        launched = int(lh.lpips_head.launches) - before
        loop = torch.stack([lh.lpips_head(a, b, wt) for a, b in zip(f0, f1)])
        ref = lh.lpips_head_plain(f0.flatten(0, 1), f1.flatten(0, 1), wt).reshape(lanes, -1)
        err = (got - ref).abs()
        check(bool((err <= HEAD_RTOL * ref.abs() + 1e-7).all()) and bool(((got - loop).abs() <= HEAD_RTOL * loop.abs() + 1e-7).all()),
              f"B3 across lanes {shape}: max abs err {float(err.max())}, against the loop {float((got - loop).abs().max())}")
        check(launched == (1 if on_card else 0), f"B3 across lanes {shape}: launches {launched}")
        a2, b2 = f0.flatten(0, 1), f1.flatten(0, 1)
        bound, by = bound_ms(lh.lpips_head_cost(a2, b2, wt), F32_FLOPS_PER_S)
        rows["B3"].append({"shape": [lanes * shape[0], *shape[1:]], "count": 1, "max_abs_err": float(err.max()),
                           "loop_rel": float(((got - loop).abs() / loop.abs().clamp_min(1e-30)).max()),
                           "bound_ms": bound, "bound_by": by, **timed(
            lambda: lh.lpips_head(a2, b2, wt), lambda: [lh.lpips_head(a, b, wt) for a, b in zip(f0, f1)],
            lambda: lh.lpips_head_plain(a2, b2, wt), None)})

    # B4 and B5: the ViT-B/16 image tower's shapes at 8 lanes x 8 images, float32, as a pool would fold them (no
    # pooled class reaches them: the CLIP towers run plain softmax and LayerNorm, as the JAX package's flax towers)
    cfg = sizes["clip"]
    tokens, hidden, heads = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1, cfg["vision_hidden"], cfg["vision_heads"]
    n_img = sizes["clip_images"]
    q, k, v = (torch.randn((lanes, n_img, tokens, hidden), generator=gen, device=dev) for _ in range(3))
    mask = torch.ones((n_img, tokens), device=dev)  # shared by the lanes
    before = int(ka.attention.launches)
    got = _under_vmap(torch, lambda a, b, c: ka.attention(a, b, c, mask, num_heads=heads), q, k, v)
    launched = int(ka.attention.launches) - before
    loop = torch.stack([ka.attention(a, b, c, mask, num_heads=heads) for a, b, c in zip(q, k, v)])
    q2, k2, v2 = (t.flatten(0, 1) for t in (q, k, v))
    m2 = mask.expand(lanes, *mask.shape).flatten(0, 1)
    ref = ka.attention_plain(q2, k2, v2, m2, num_heads=heads).reshape(got.shape)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= ATT_F32_RTOL * scale and like_loop(got, loop, ATT_F32_RTOL) and launched == (1 if on_card else 0),
          f"B4 across lanes: max abs err {err} at scale {scale}, equal to the loop {torch.equal(got, loop)}, {launched} launches")
    split = lambda t: t.view(lanes * n_img, tokens, heads, hidden // heads).transpose(1, 2)  # noqa: E731
    cost = ka.attention_cost(q2, k2, v2, m2, num_heads=heads)
    bound, by = bound_ms(dataclasses.replace(cost, flops=3 * cost.flops), TF32_FLOPS_PER_S)
    rows["B4"].append({"shape": [lanes * n_img, tokens, hidden], "count": cfg["vision_layers"], "max_abs_err": err,
                       "bound_ms": bound, "bound_by": by, **timed(
        lambda: ka.attention(q2, k2, v2, m2, num_heads=heads),
        lambda: [ka.attention(a, b, c, mask, num_heads=heads) for a, b, c in zip(q, k, v)],
        lambda: ka.attention_plain(q2, k2, v2, m2, num_heads=heads),
        lambda: F.scaled_dot_product_attention(split(q2), split(k2), split(v2)), reps=10)})
    scale_w, shift = torch.rand(hidden, generator=gen, device=dev) + 0.5, 0.1 * torch.randn(hidden, generator=gen, device=dev)
    before = int(ka.layernorm_residual.launches)
    got = _under_vmap(torch, lambda a, b: ka.layernorm_residual(a, b, scale_w, shift, eps=1e-5), q, k)
    launched = int(ka.layernorm_residual.launches) - before
    loop = torch.stack([ka.layernorm_residual(a, b, scale_w, shift, eps=1e-5) for a, b in zip(q, k)])
    ref = ka.layernorm_residual_plain(q, k, scale_w, shift, eps=1e-5)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= LN_RTOL * scale and like_loop(got, loop, LN_RTOL) and launched == (1 if on_card else 0),
          f"B5 across lanes: max abs err {err} at scale {scale}, equal to the loop {torch.equal(got, loop)}, {launched} launches")
    bound, by = bound_ms(ka.layernorm_residual_cost(q, k, scale_w, shift), F32_FLOPS_PER_S)
    rows["B5"].append({"shape": [lanes * n_img * tokens, hidden], "count": 2 * cfg["vision_layers"], "max_abs_err": err,
                       "bound_ms": bound, "bound_by": by, **timed(
        lambda: ka.layernorm_residual(q, k, scale_w, shift, eps=1e-5),
        lambda: [ka.layernorm_residual(a, b, scale_w, shift, eps=1e-5) for a, b in zip(q, k)],
        lambda: ka.layernorm_residual_plain(q, k, scale_w, shift, eps=1e-5),
        lambda: F.layer_norm(q + k, (hidden,), scale_w, shift, 1e-5), reps=10)})
    del q, k, v, q2, k2, v2, got, loop, ref

    # S1: SRMR's two banks at 8 lanes x 2 utterances of 8 s (23 gammatone channels, then 8 modulation bands each);
    # the plain loop at a cut length, where a step a sample stays within the phase's time
    srmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    num, den, gain = (torch.from_numpy(a.astype(np.float32)) for a in srmr._gammatone_coefs(16_000, 23, 125.0))
    mod_num, mod_den, _ = srmr._modulation_filterbank(4.0, 128.0, 8, 16_000.0, 2.0)
    mnum = torch.from_numpy((mod_num / mod_den[:, :1]).astype(np.float32))[None]
    mden = torch.from_numpy((mod_den / mod_den[:, :1]).astype(np.float32))
    utt, samples, cut = sizes["srmr_utterances"], sizes["srmr_samples"], sizes["s1_plain_samples"]
    x = reverb_utterances(torch, dev, gen, lanes * utt, samples, 16_000).view(lanes, utt, samples)
    for bank, (b, a, g), rows_in in (("gammatone", (num, den, gain), x),
                                     ("modulation", (mnum, mden, None), None)):
        if rows_in is None:  # the modulation bank filters the gammatone bank's envelopes: its own rows
            rows_in = torch.rand((lanes, utt * 23, samples), generator=gen, device=dev)
        before = int(kb.biquad_bank.launches)
        got = _under_vmap(torch, lambda t: kb.biquad_bank(t, b, a, g), rows_in)
        launched = int(kb.biquad_bank.launches) - before
        loop = torch.stack([kb.biquad_bank(t, b, a, g) for t in rows_in])
        short = rows_in[..., :cut].contiguous()
        got_short = _under_vmap(torch, lambda t: kb.biquad_bank(t, b, a, g), short)
        ref = kb.biquad_bank_plain(short.flatten(0, 1), b, a, g).reshape(got_short.shape)
        err = float((got_short - ref).abs().max())
        check(torch.equal(got, loop) and torch.equal(got_short, ref) and launched == (1 if on_card else 0),
              f"S1 across lanes ({bank}): equal to the loop {torch.equal(got, loop)}, max abs err {err} against "
              f"its plain loop at {cut} samples, {launched} launches")
        folded = rows_in.flatten(0, 1)
        cost = kb.biquad_bank_cost(folded.shape[0], b.shape[1], samples, b.shape[0])
        bound, by = bound_ms(cost, F32_FLOPS_PER_S)
        short2 = short.flatten(0, 1)
        rows["S1"].append({"bank": bank, "shape": [folded.shape[0], b.shape[1], samples], "count": 1,
                           "max_abs_err": err, "bound_ms": bound, "bound_by": by, **timed(
            lambda: kb.biquad_bank(folded, b, a, g), lambda: [kb.biquad_bank(t, b, a, g) for t in rows_in],
            lambda: kb.biquad_bank_plain(short2, b, a, g), None, reps=5, plain_reps=2)})
        del got, loop, got_short, ref
    per_forward = {}
    for name, kernel_rows in rows.items():
        total = {"launches_per_forward": sum(r["count"] for r in kernel_rows),
                 "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
                 "bound_ms": sum(r["bound_ms"] * r["count"] for r in kernel_rows),
                 "bound_by": collections.Counter(r["bound_by"] for r in kernel_rows).most_common(1)[0][0]}
        for key in ("ms", "loop_ms", "plain_ms", "library_ms"):
            vals = [r.get(key) for r in kernel_rows]
            total[key] = None if None in vals else sum(v * r["count"] for v, r in zip(vals, kernel_rows))
        per_forward[name] = total
    return {"per_forward": per_forward, "rows": rows}


def _pool_run(torch, np, name, make, steps, keys, counters, tenants: int, lanes: int, on_card: bool) -> dict:
    """One trunk pool: ``warm_start`` for each key, then the counted steps; its graphs and host ms a step.

    ``steps``: ``(group, round, args, kwargs)``, whose lanes are tenants ``group * lanes`` on; ``keys``: one
    example step for each key.
    """
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    pool = make().to_stream_pool(capacity=tenants)
    slots = [pool.attach() for _ in range(tenants)]
    ids = lambda g: np.asarray(slots[g * lanes:(g + 1) * lanes])  # noqa: E731
    t0 = time.perf_counter()
    warm = [pool.warm_start(ids(g), *args, **kwargs) for g, _, args, kwargs in keys]
    check(all(w["stream_step"] == "compiled" for w in warm), f"{name}: warm_start {warm}")
    warm_seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    host = []
    t0 = time.perf_counter()
    for g, _, args, kwargs in steps:  # the main path: counted from here
        h0 = time.perf_counter()
        pool.update(ids(g), *args, **kwargs)
        host.append((time.perf_counter() - h0) * 1e3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: int(c) for k, c in counters.items()}  # the main path: read here
    check(pool.capture_failures == {}, f"{name}: captures failed: {pool.capture_failures}")
    if on_card:
        check(len(pool._step_fns) == len(keys) and all(isinstance(e, compile_mod.CapturedStep)
                                                       for e in pool._step_fns.values()),
              f"{name}: {len(pool._step_fns)} steps for {len(keys)} keys, not all CUDA graphs")
    check(all(pool.stream_update_count(s) == sum(1 for g, *_ in steps if s // lanes == g) for s in slots),
          f"{name}: update counts {[pool.stream_update_count(s) for s in slots]}")
    return {"pool": pool, "slots": slots, "ids": ids, "warm": warm, "warm_seconds": warm_seconds,
            "launches": launches, "seconds": seconds, "host_ms_median": statistics.median(host),
            "pool_bytes": compile_mod.pool_bytes(pool._graph_pool) if on_card else 0,
            "pool_bound_bytes": compile_mod._pool_bound(pool.device) if on_card else None}


def _pool_step_ms(torch, run, steps, reps: int) -> dict:
    """Host ms to return and device ms between CUDA events of the pool's replayed steps (medians)."""
    host, events = [], []
    for i in range(reps):
        g, _, args, kwargs = steps[i % len(steps)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        run["pool"].update(run["ids"](g), *args, **kwargs)
        end.record()
        host.append((time.perf_counter() - h0) * 1e3)
        events.append((start, end))
    torch.cuda.synchronize()
    return {"host_ms_per_step": statistics.median(host),
            "device_ms_per_step": statistics.median(s.elapsed_time(e) for s, e in events)}


def phase_trunk_pools(torch, np, ce, lh, ka, kb, dev, gen, seed: int, smi: str, npz_folder: str,
                      sizes=None) -> dict:
    """Phase 53: the four trunk metrics the JAX package pools, through ``to_stream_pool`` on the card.

    FID (2048 features), LPIPS alex, CLIPScore ViT-B/16 and SRMR, each a pool of 16 tenants: ``warm_start`` per key,
    then micro-batches of 8 lanes whose trunk forward runs inline in the pool's CUDA graph, each trunk kernel
    launched once a micro-batch through its vmap rule (a pooled step launches what one forward launches, replays
    counted). Every tenant's states and ``compute(i)`` against an eager twin fed the same batches
    (``TRUNK_POOL_RTOL``), FID's ``compute_all`` raising (the host read of its ``compute`` under vmap, as the JAX
    pool's ``compute`` under jit), the pool graph's bytes against ``_compile._pool_bound``, host and device ms a
    step against the eager twins' for the same images, and each kernel's lane-batched launch
    (:func:`trunk_lane_kernels`).
    """
    from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor
    from torchmetrics_tpu_torch.multimodal import CLIPScore

    sizes = dict(TRUNK_POOL_SIZES, **(sizes or {}))
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    tenants, lanes = sizes["tenants"], sizes["lanes"]
    groups = tenants // lanes
    counters = {name: fn.launches for name, fn in (("B2a", ce.matmul_bias_relu), ("B2b", ce.bias_relu_),
                                                   ("B3", lh.lpips_head), ("B4", ka.attention),
                                                   ("B5", ka.layernorm_residual), ("S1", kb.biquad_bank))}
    rng = np.random.default_rng([seed, 53])
    inception = inception_npz(torch, np, seed, npz_folder, dev, gen)
    clip_b = clip_npz(torch, np, sizes["clip"], seed + 2, npz_folder, dev)
    fi, fr = sizes["fid_images"], sizes["fid_rounds"]
    lp, ls, lr = sizes["lpips_pairs"], sizes["lpips_side"], sizes["lpips_rounds"]
    ci, cr, cs = sizes["clip_images"], sizes["clip_rounds"], sizes["clip"]["image_size"]
    su, ss, sr = sizes["srmr_utterances"], sizes["srmr_samples"], sizes["srmr_rounds"]
    # (tenants, rounds, ...) batches made on the card; a micro-batch is the rows of one group's tenants
    fid_imgs = torch.randint(0, 256, (tenants, fr, fi, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    lp0 = torch.rand((tenants, lr, lp, 3, ls, ls), generator=gen, device=dev) * 2 - 1
    lp1 = (lp0 + 0.3 * torch.randn(lp0.shape, generator=gen, device=dev)).clamp_(-1, 1)
    clip_imgs = natural_images(torch, dev, gen, tenants * cr * ci, cs, cs).float().div_(255).view(tenants, cr, ci, 3, cs, cs)
    captions = [coco_captions(np, rng, ci) for _ in range(cr)]
    audio = reverb_utterances(torch, dev, gen, tenants * sr * su, ss, 16_000).view(tenants, sr, su, ss)
    rows = lambda t, g, r: t[g * lanes:(g + 1) * lanes, r]  # noqa: E731
    cases = {  # name: (make(auto_compile), steps (group, round, args, kwargs), launches a forward, a tenant's batch)
        "fid": (lambda auto=True: FrechetInceptionDistance(feature=2048, weights_path=inception, auto_compile=auto),
                [(g, r, (rows(fid_imgs, g, r),), {"real": r % 2 == 0}) for r in range(fr) for g in range(groups)],
                {"B2a": 40, "B2b": 54}, lambda t, r: ((fid_imgs[t, r],), {"real": r % 2 == 0})),
        "lpips_alex": (lambda auto=True: LearnedPerceptualImagePatchSimilarity(net_type="alex", auto_compile=auto),
                       [(g, r, (rows(lp0, g, r), rows(lp1, g, r)), {}) for r in range(lr) for g in range(groups)],
                       {"B3": 5}, lambda t, r: ((lp0[t, r], lp1[t, r]), {})),
        "clipscore_vit_b16": (lambda auto=True: CLIPScore(weights_path=clip_b, tokenizer=ClipTokenizer(), auto_compile=auto),
                              [(g, r, (rows(clip_imgs, g, r), captions[r]), {}) for r in range(cr) for g in range(groups)],
                              {}, lambda t, r: ((clip_imgs[t, r], captions[r]), {})),
        "srmr": (lambda auto=True: SpeechReverberationModulationEnergyRatio(16_000, auto_compile=auto),
                 [(g, r, (rows(audio, g, r),), {}) for r in range(sr) for g in range(groups)],
                 {"S1": 2}, lambda t, r: ((audio[t, r],), {})),
    }
    out, memory = {}, {}
    for name, (make, steps, per_forward, twin_batch) in cases.items():
        # one example step a key: FID's real and fake flags, CLIPScore's caption lists
        keys = list({repr((kw, [a for a in args if not isinstance(a, torch.Tensor)])): (g, r, args, kw)
                     for g, r, args, kw in steps}.values())
        run = _pool_run(torch, np, name, make, steps, keys, counters, tenants, lanes, on_card)
        pool = run["pool"]
        want = {k: per_forward.get(k, 0) * len(steps) * on_card for k in counters}
        check(run["launches"] == want, f"{name}: launches {run['launches']}, expected {want} (one forward a step)")
        check(not on_card or run["pool_bytes"] <= run["pool_bound_bytes"],
              f"{name}: the pool's graphs hold {run['pool_bytes']} bytes, over {run['pool_bound_bytes']}")
        # every tenant against one eager twin, reset between tenants and fed the tenant's rows of each step
        twin, states = make(False), pool.state_dict()
        state_rel, value_rel, twin_ms, values = 0.0, 0.0, [], {}
        for s, slot in enumerate(run["slots"]):
            twin.reset()
            for r in [r for g, r, _, _ in steps if g == s // lanes]:
                args, kwargs = twin_batch(s, r)
                h0 = time.perf_counter()
                twin.update(*args, **kwargs)
                torch.cuda.synchronize()
                twin_ms.append((time.perf_counter() - h0) * 1e3)
            for key in twin._defaults:
                state_rel = max(state_rel, _tensor_rel(torch, torch.as_tensor(states[key][slot]), getattr(twin, key).cpu()))
            values[slot] = pool.compute(slot)
            value_rel = max(value_rel, _tensor_rel(torch, values[slot].reshape(-1).cpu(), twin.compute().reshape(-1).cpu()))
        tol = TRUNK_POOL_RTOL[name.split("_")[0].replace("clipscore", "clip")]
        check(state_rel <= tol and value_rel <= tol,
              f"{name}: pooled tenants vs eager twins: states {state_rel}, values {value_rel} (tolerance {tol})")
        raised = None
        if name == "fid":  # the host read of FID's compute under vmap, as the JAX pool's compute under jit
            try:
                pool.compute_all()
            except RuntimeError as err:
                raised = str(err)[:100]
            check(raised is not None, "fid: compute_all did not raise")
        else:
            every = pool.compute_all()
            check(all(torch.allclose(every[s], values[s], rtol=1e-5, atol=1e-6) for s in run["slots"]),
                  f"{name}: compute_all != compute(i)")
        steady = _pool_step_ms(torch, run, steps, sizes["timed_steps"]) if on_card else {}
        units = steps[0][2][0].shape[0] * steps[0][2][0].shape[1]  # images, pairs or utterances a step
        line = {
            "phase": "trunk_pools", "metric": name, "tenants": tenants, "lanes": lanes, "steps": len(steps),
            "units_per_step": units, "keys": len(keys), "warm_start": run["warm"][0],
            "warm_seconds": run["warm_seconds"], "launches": run["launches"], "expected_launches": want,
            "max_rel": {"states": state_rel, "values": value_rel}, "tolerance": tol, "compute_all_raised": raised,
            "graph_pool_bytes": run["pool_bytes"], "pool_bound_bytes": run["pool_bound_bytes"],
            "counted_seconds": run["seconds"], "host_ms_median_counted": run["host_ms_median"], **steady,
            # the eager twin's ms (host clock, synchronized) for one tenant's update, times the lanes: the same units
            "eager_twin_ms_per_step": statistics.median(twin_ms) * lanes, "card": smi,
        }
        emit(line)
        out[name] = line
        memory[name] = {"graph_pool_bytes": run["pool_bytes"], "keys": len(keys)}
        del pool, run, twin, values, states
        release_graphs(torch)
    del fid_imgs, lp0, lp1, clip_imgs, audio

    # each kernel's lane-batched launch at the folded shapes
    probe = InceptionFeatureExtractor(feature="2048", device=dev)
    calls = inception_conv_calls(probe, torch.zeros((fi, 3, 32, 32), dtype=torch.uint8, device=dev))
    del probe
    taps = lpips_tap_shapes(torch, dev, "alex", pairs=lp, side=ls)
    kernels = trunk_lane_kernels(torch, np, ce, lh, ka, kb, dev, gen, calls, taps, sizes)
    release_graphs(torch)
    seconds = time.perf_counter() - t_phase
    launches = {k: sum(line["launches"][k] for line in out.values()) for k in counters}
    emit({"phase": "trunk_pools", "seconds": seconds, "launches": launches, "memory": memory,
          "lane_kernels_per_forward": kernels["per_forward"],
          "at": "per forward of the pooled main path, folded over 8 lanes: FID 8 x 25 images (40 B2a, 54 B2b), alex "
                "8 x 8 pairs of 256x256 (5 B3), ViT-B/16 image tower 8 x 8 images (12 B4, 24 B5, float32; no pooled "
                "class launches them), SRMR 8 x 2 x 128,000 samples (2 S1); ms: queued_ms of the folded launch; "
                "loop_ms: queued_ms of one launch a lane", "card": smi})
    return {"seconds": seconds, "launches": launches, "kernels": kernels["per_forward"], "pools": out}


# ------------------------------------------------------------------ spmd_collection
# phase 54: BASELINE config 2's collection through the SPMD engine on one card: a mesh of 8 rows on the card, the
# imagenet_val data (50,000 x 1,000 classes) in global batches of 1,024 (8 rows x 128), the last batch of 848 a
# second signature; LPIPS alex through the engine at 8 rows x 8 pairs of 256x256
SPMD_SIZES = {"rows": 8, "batch": 1024, "fault_at": 20, "snapshot_every": 10, "short_steps": 30, "group_steps": 6,
              "default_steps": 3, "lpips_pairs": 8, "lpips_side": 256, "lpips_steps": 3, "timed_steps": 24}
SPMD_RATIO_ATOL = 1e-6  # accuracy, F1, MCC and Jaccard of the engine against the eager stream: float32 ratios of equal counts


def spmd_members(tp, c: int, dev, **kw) -> dict:
    """BASELINE config 2's in-graph members: macro accuracy and F1, the confusion matrix, MCC and Jaccard."""
    return {
        "acc": tp.MulticlassAccuracy(num_classes=c, device=dev, **kw),
        "f1": tp.MulticlassF1Score(num_classes=c, device=dev, **kw),
        "cm": tp.MulticlassConfusionMatrix(num_classes=c, device=dev, **kw),
        "mcc": tp.MulticlassMatthewsCorrCoef(num_classes=c, device=dev, **kw),
        "jaccard": tp.MulticlassJaccardIndex(num_classes=c, device=dev, **kw),
    }


def _spmd_diff(torch, got: dict, want: dict) -> dict:
    """The confusion matrix equal (a bool), and the largest absolute difference of each ratio."""
    out = {"cm_equal": bool(torch.equal(got["cm"], want["cm"]))}
    for k in ("acc", "f1", "mcc", "jaccard"):
        out[k] = float((got[k].double() - want[k].double()).abs().max())
    return out


def _spmd_ok(d: dict) -> bool:
    return d["cm_equal"] and all(d[k] <= SPMD_RATIO_ATOL for k in ("acc", "f1", "mcc", "jaccard"))


def phase_spmd_collection(torch, np, kernel, lh, dev, gen, logits, target, smi: str, sizes=None) -> dict:
    """Phase 54: the SPMD engine (``_spmd``) on the card, through ``MetricCollection.to_spmd``.

    1. The main path: BASELINE config 2's in-graph members (``spmd_members``; its AUROC is certified ``host_bound``
       and keeps the eager gather, which the phase checks) on a mesh of 8 rows on the card, the imagenet_val data in
       global batches of 1,024 (8 x 128), the last of 848. Every step's value against the eager stream
       (``update`` then ``compute``): the confusion matrix bit for bit, the ratios within ``SPMD_RATIO_ATOL``; the
       final matrix against a numpy bincount. B1's lane-batched launches rise by one a step; two keys, two CUDA
       graphs, every later step a replay.
    2. ``to_spmd()`` on the default mesh (every visible card: a world of 1 here), against the eager stream.
    3. Replica groups ``[[0, 1, 2, 3], [4, 5, 6, 7]]``: each replica's value against an eager collection fed only its
       group's shards.
    4. A step failure injected at step 20 of 30 (``inject_step_failure(times=1)``): the fold and the eager
       continuation end bit for bit with the uninterrupted eager stream.
    5. A ``SnapshotManager`` on an engine, every 10 steps: a restore into a fresh engine at step 25's newest boundary
       (20) finishes the 30 steps bit for bit with the uninterrupted engine.
    6. LPIPS alex through the engine, 8 rows x 8 pairs of 256x256: B3 once a tap a step, the value against an eager
       LPIPS on the same pairs.
    7. Host and device ms a step (medians) of the engine's replays and of the eager stream with a compute a step,
       kernels a step, graph memory, and the lane-batched B1 and B3 launches at this phase's shapes: ``queued_ms``
       beside the bound and the plain version.
    """
    tp = importlib.import_module("torchmetrics_tpu_torch")
    spmd = importlib.import_module("torchmetrics_tpu_torch._spmd")
    spmd_fi = importlib.import_module("torchmetrics_tpu_torch._spmd.faultinject")
    res = importlib.import_module("torchmetrics_tpu_torch._resilience")
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    specs = importlib.import_module("torchmetrics_tpu_torch._spmd.specs")
    sizes = dict(SPMD_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    n_val, c = logits.shape
    rows, batch = sizes["rows"], sizes["batch"]
    starts = list(range(0, n_val, batch))
    batches = [(logits[s:s + batch], target[s:s + batch]) for s in starts]
    check(batches[-1][0].shape[0] % rows == 0, f"the last batch of {batches[-1][0].shape[0]} does not shard over {rows}")
    mesh = spmd.build_mesh(devices=[dev] * rows)
    lanes_k, b1 = kernel.confusion_matrix_lanes.launches, kernel.confusion_matrix_cuda.launches

    def collection(**kw):
        return tp.MetricCollection(spmd_members(tp, c, dev, **kw))

    # AUROC keeps the eager gather, as in the JAX package
    auroc_facet = specs.in_graph_sync_eligible(tp.MulticlassAUROC)
    check(auroc_facet == "host_bound", f"MulticlassAUROC's in_graph_sync facet is {auroc_facet}")
    try:
        tp.MetricCollection({**spmd_members(tp, c, dev), "auroc": tp.MulticlassAUROC(num_classes=c, thresholds=100,
                                                                                     device=dev)}).to_spmd(mesh=mesh)
        auroc_refused = None
    except spmd.InGraphSyncUnsupported as err:
        auroc_refused = str(err)[:120]
    check(auroc_refused is not None, "a collection with AUROC was let onto the in-graph path")

    # ------------------------------------------------------------ 1. the main path
    eng = collection().to_spmd(mesh=mesh)
    eager = collection(auto_compile=False)  # the graphs counted below are the engine's alone
    short = sizes["short_steps"]
    keep = {sizes["fault_at"] + 1, short}  # the uninterrupted streams' values the later parts end on
    eager_at, engine_at, worst = {}, {}, {"cm_equal": True, "acc": 0.0, "f1": 0.0, "mcc": 0.0, "jaccard": 0.0}
    per_step, host_ms = [], []
    stats0 = compile_mod.stats()
    b1_0 = int(b1)
    lanes_k.reset()  # the main path: counted from here
    for i, (p, t) in enumerate(batches):
        before = int(lanes_k)
        h0 = time.perf_counter()
        got = eng.step(p, t)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        per_step.append(int(lanes_k) - before)
        eager.update(p, t)
        want = eager.compute()
        d = _spmd_diff(torch, got, want)
        check(_spmd_ok(d), f"step {i}: the engine against the eager stream: {d}")
        worst = {k: (worst[k] and v) if k == "cm_equal" else max(worst[k], v) for k, v in d.items()}
        if i + 1 in keep:
            eager_at[i + 1], engine_at[i + 1] = want, got
    if on_card:
        torch.cuda.synchronize()
    lanes_launches = int(lanes_k)  # the main path: read here
    stats1 = compile_mod.stats()
    steps = len(batches)
    check(lanes_launches == (steps if on_card else 0) and set(per_step) == {1 if on_card else 0},
          f"B1 lane-batched launches {lanes_launches} for {steps} steps ({sorted(set(per_step))} a step)")
    check(not eng.degraded and eng.capture_failures == {}, f"degraded {eng.degraded}, captures {eng.capture_failures}")
    check(len(eng._step_fns) == 2, f"{len(eng._step_fns)} keys for two batch shapes")
    graphs = {"captured": stats1["captured"] - stats0["captured"], "replayed": stats1["replayed"] - stats0["replayed"]}
    if on_card:
        check(all(isinstance(e, compile_mod.CapturedStep) for e in eng._step_fns.values()), "a key is not a CUDA graph")
        check(graphs == {"captured": 2, "replayed": steps - 2}, f"graphs {graphs} for {steps} steps")
    check(len(eng._units) == 2 and sorted(len(u.members) for u in eng._units) == [2, 3],
          f"compute groups {[[n for n, _ in u.members] for u in eng._units]}")
    preds_all = logits.argmax(-1).cpu().numpy()
    ref = np.bincount(target.cpu().numpy() * c + preds_all, minlength=c * c).reshape(c, c)
    check(np.array_equal(got["cm"].cpu().numpy(), ref), "the engine's final confusion matrix != the numpy bincount")
    graph_bytes = compile_mod.pool_bytes(eng._graph_pool) if on_card else 0
    main = {"steps": steps, "batch": batch, "last_batch": int(batches[-1][0].shape[0]), "rows": rows,
            "lanes_launches": lanes_launches, "graphs": graphs, "worst_vs_eager": worst,
            "host_ms_median_checked_stream": statistics.median(host_ms), "graph_pool_bytes": graph_bytes,
            "groups": [[n for n, _ in u.members] for u in eng._units]}

    # ------------------------------------------------------------ 2. the default mesh
    default = collection().to_spmd()
    twin = collection()
    for p, t in batches[:sizes["default_steps"]]:
        got_default = default.step(p, t)
        twin.update(p, t)
    d = _spmd_diff(torch, got_default, twin.compute())
    check(_spmd_ok(d) and default.world == torch.cuda.device_count(), f"default mesh: world {default.world}, {d}")
    default_line = {"world": default.world, "steps": sizes["default_steps"], "vs_eager": d}
    del default, twin

    # ------------------------------------------------------------ 3. replica groups
    groups = [list(range(rows // 2)), list(range(rows // 2, rows))]
    grouped = collection().to_spmd(mesh=mesh, groups=groups)
    replicas = [collection() for _ in groups]
    for p, t in batches[:sizes["group_steps"]]:
        out = grouped.step(p, t)
        shard = p.shape[0] // rows
        for gi, g in enumerate(groups):
            idx = torch.cat([torch.arange(r * shard, (r + 1) * shard, device=dev) for r in g])
            replicas[gi].update(p[idx], t[idx])
    group_diffs = [_spmd_diff(torch, out[gi], replicas[gi].compute()) for gi in range(len(groups))]
    check(sorted(out) == [0, 1] and all(_spmd_ok(d) for d in group_diffs), f"replica groups: {group_diffs}")
    del grouped, replicas

    # ------------------------------------------------------------ 4. an injected step failure
    faulted = collection().to_spmd(mesh=mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (p, t) in enumerate(batches[:short]):
            if i == sizes["fault_at"]:
                with spmd_fi.inject_step_failure(times=1):
                    last = faulted.step(p, t)
                check(faulted.degraded, "the injected failure did not degrade the engine")
                d = _spmd_diff(torch, last, eager_at[i + 1])
                check(d["cm_equal"] and all(d[k] == 0.0 for k in ("acc", "f1", "mcc", "jaccard")),
                      f"the fold and the failed batch run eagerly vs the uninterrupted eager stream: {d}")
            else:
                last = faulted.step(p, t)
    events = [e for m in faulted.target.values() for e in m.resilience_report().events if e.kind == "spmd_degraded"]
    check(len(events) == 1 and "restarts" not in events[0].detail, f"degradation events {[e.detail for e in events]}")
    d = _spmd_diff(torch, last, eager_at[short])
    check(d["cm_equal"] and all(d[k] == 0.0 for k in ("acc", "f1", "mcc", "jaccard")),
          f"fold + eager continuation vs the uninterrupted eager stream: {d}")
    fault_line = {"at_step": sizes["fault_at"], "steps": short, "vs_uninterrupted_eager": d,
                  "event": events[0].detail[:160]}
    del faulted

    # ------------------------------------------------------------ 5. snapshot and restore
    with tempfile.TemporaryDirectory() as folder:
        live = collection().to_spmd(mesh=mesh)
        mgr = res.SnapshotManager(live, folder, res.SnapshotPolicy(every_n_updates=sizes["snapshot_every"],
                                                                  async_write=False))
        cut = sizes["fault_at"] + sizes["snapshot_every"] // 2
        for p, t in batches[:cut]:
            live.step(p, t)
        mgr.close()  # the process is preempted here
        restored = collection().to_spmd(mesh=mesh)
        mgr2 = res.SnapshotManager(restored, folder, res.SnapshotPolicy(async_write=False))
        report = mgr2.restore_latest()
        mgr2.close()
        resume = restored.steps
        for p, t in batches[resume:short]:
            last = restored.step(p, t)
        d = _spmd_diff(torch, last, engine_at[short])
        check(d["cm_equal"] and all(d[k] == 0.0 for k in ("acc", "f1", "mcc", "jaccard")) and not restored.degraded,
              f"restore at {resume} and stream to {short} vs the uninterrupted engine: {d}")
        snapshot_line = {"preempted_at": cut, "restored_at": resume, "generation": report.generation,
                         "vs_uninterrupted_engine": d}
        del live, restored

    # ------------------------------------------------------------ 6. LPIPS alex through the engine
    lp, ls = sizes["lpips_pairs"], sizes["lpips_side"]
    img0 = torch.rand((sizes["lpips_steps"], rows * lp, 3, ls, ls), generator=gen, device=dev) * 2 - 1
    img1 = (img0 + 0.3 * torch.randn(img0.shape, generator=gen, device=dev)).clamp_(-1, 1)
    lp_eng = tp.LearnedPerceptualImagePatchSimilarity(net_type="alex", device=dev).to_spmd(mesh=mesh)
    lp_eager = tp.LearnedPerceptualImagePatchSimilarity(net_type="alex", device=dev, auto_compile=False)
    b3 = lh.lpips_head.launches
    b3.reset()  # this part's main path: counted from here
    for k in range(sizes["lpips_steps"]):
        lp_got = lp_eng.step(img0[k], img1[k])
    if on_card:
        torch.cuda.synchronize()
    b3_launches = int(b3)  # read here
    for k in range(sizes["lpips_steps"]):
        lp_eager.update(img0[k], img1[k])
    lp_want = lp_eager.compute()
    lp_rel = abs(float(lp_got) - float(lp_want)) / abs(float(lp_want))
    check(b3_launches == (5 * sizes["lpips_steps"] if on_card else 0), f"B3 launches {b3_launches}")
    check(lp_rel <= TRUNK_POOL_RTOL["lpips"] and not lp_eng.degraded and lp_eng.capture_failures == {},
          f"LPIPS through the engine: rel {lp_rel}, degraded {lp_eng.degraded}, captures {lp_eng.capture_failures}")
    lpips_line = {"rows": rows, "pairs_per_row": lp, "side": ls, "steps": sizes["lpips_steps"],
                  "b3_launches": b3_launches, "value_rel_vs_eager": lp_rel, "tolerance": TRUNK_POOL_RTOL["lpips"],
                  "graph_pool_bytes": compile_mod.pool_bytes(lp_eng._graph_pool) if on_card else 0}

    # ------------------------------------------------------------ 7. timings
    timing = {}
    if on_card:
        p, t = batches[0]

        def host_device(fn, reps):
            hosts, events = [], []
            for _ in range(reps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                hosts.append((time.perf_counter() - h0) * 1e3)
                events.append((start, end))
            torch.cuda.synchronize()
            return {"host_ms": statistics.median(hosts), "device_ms": statistics.median(s.elapsed_time(e) for s, e in events)}

        timing["engine_step"] = host_device(lambda: eng.step(p, t), sizes["timed_steps"])
        timing["eager_update_compute"] = host_device(lambda: (eager.update(p, t), eager.compute()), sizes["timed_steps"])
        compiled = collection()  # the default path: each head's update a CUDA graph, compute eager
        timing["compiled_update_compute"] = host_device(lambda: (compiled.update(p, t), compiled.compute()),
                                                        sizes["timed_steps"])
        timing["engine_kernels"] = device_time_by_kernel(torch, lambda: eng.step(p, t), top=6)
        timing["eager_kernels"] = device_time_by_kernel(torch, lambda: (eager.update(p, t), eager.compute()), top=6)
        timing["compiled_kernels"] = device_time_by_kernel(torch, lambda: (compiled.update(p, t), compiled.compute()),
                                                           top=6)
        del compiled
        timing["lpips_engine_step"] = host_device(lambda: lp_eng.step(img0[0], img1[0]), 8)
        # B1 across the 8 rows at this phase's shape: (8, 128) int64 labels under a bool mask into (8, C, C) int32 rows
        rp, rt = p.argmax(-1).reshape(rows, -1).contiguous(), t.reshape(rows, -1).contiguous()
        rv = torch.ones_like(rt, dtype=torch.bool)
        buf = torch.zeros((rows, c, c), dtype=torch.int32, device=dev)
        got_lanes = kernel.confusion_matrix_lanes(rp, rt, c, rv)
        want_lanes = kernel.confusion_matrix_lanes_plain(rp, rt, c, rv)
        check(torch.equal(got_lanes, want_lanes), "B1 across the rows != its plain version")
        fused = (rt * c + rp + torch.arange(rows, device=dev)[:, None] * (c * c)).reshape(-1)
        timing["b1_lanes"] = {
            "shape": [rows, rp.shape[1], c], "max_abs_err": float((got_lanes - want_lanes).abs().max()),
            "ms": queued_ms(torch, lambda: kernel.confusion_matrix_lanes(rp, rt, c, rv, out=buf), reps=50),
            "plain_ms": median_ms(torch, lambda: kernel.confusion_matrix_lanes_plain(rp, rt, c, rv), reps=10),
            "library_ms": median_ms(torch, lambda: torch.bincount(fused, minlength=rows * c * c), reps=20),
            # the labels and the mask, read once (as phase 52 bounds B1 across lanes)
            "bound_ms": rp.numel() * (2 * rp.element_size() + rv.element_size()) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
        }
        # B3 across the 8 rows: alex's five taps at 8 rows x 8 pairs, one folded launch each
        b3_rows = []
        for shape in lpips_tap_shapes(torch, dev, "alex", pairs=lp, side=ls):
            f0 = torch.randn((rows * shape[0], *shape[1:]), generator=gen, device=dev).relu_().bfloat16()
            f1 = (f0.float() + 0.3 * torch.randn(f0.shape, generator=gen, device=dev)).relu_().bfloat16()
            wt = torch.rand(shape[-1], generator=gen, device=dev)
            got3, want3 = lh.lpips_head(f0, f1, wt), lh.lpips_head_plain(f0, f1, wt)
            err = (got3 - want3).abs()
            check(bool((err <= HEAD_RTOL * want3.abs() + 1e-7).all()), f"B3 across the rows {shape}: {float(err.max())}")
            bound, by = bound_ms(lh.lpips_head_cost(f0, f1, wt), F32_FLOPS_PER_S)
            b3_rows.append({"shape": list(f0.shape), "max_abs_err": float(err.max()), "bound_ms": bound, "bound_by": by,
                            "ms": queued_ms(torch, lambda: lh.lpips_head(f0, f1, wt), reps=30),
                            "plain_ms": median_ms(torch, lambda: lh.lpips_head_plain(f0, f1, wt), reps=5, warmup=1)})
        timing["b3_lanes"] = {
            "taps": b3_rows, **{k: sum(r[k] for r in b3_rows) for k in ("ms", "plain_ms", "bound_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in b3_rows),
            "bound_by": "operations" if sum(r["bound_by"] == "operations" for r in b3_rows) > 2 else "bytes",
        }
    del eng, eager, lp_eng, lp_eager
    release_graphs(torch)
    seconds = time.perf_counter() - t_phase
    out = {
        "phase": "spmd_collection", "samples": n_val, "classes": c, "members": ["acc", "f1", "cm", "mcc", "jaccard"],
        "auroc": {"facet": auroc_facet, "refused": auroc_refused}, "main": main, "default_mesh": default_line,
        "replica_groups": {"groups": groups, "steps": sizes["group_steps"], "vs_eager": group_diffs},
        "injected_failure": fault_line, "snapshot_restore": snapshot_line, "lpips_alex": lpips_line,
        "timing": timing, "b1_unbatched_launches": int(b1) - b1_0,
        "tolerance": {"confusion_matrix": "exact", "ratios": SPMD_RATIO_ATOL, "lpips_rel": TRUNK_POOL_RTOL["lpips"]},
        "seconds": seconds, "card": smi,
    }
    emit(out)
    return out


# ------------------------------------------------------------------ metric_server
# phase 55: the serving runtime (`_serving.MetricServer`) over phase 52's 1,000-class confusion-matrix pool: 256
# tenants, 50,000 labels each in requests of 1,024 rows (the last of 848), 12,544 requests from 8 client threads
# that own 32 tenants each; every micro-batch is one replay of its bucket's CUDA graph, B1 once across its lanes
SERVER_SIZES = {"classes": 1000, "tenants": 256, "capacity": 256, "queue_capacity": 1024, "max_batch": 64,
                "rows": 1024, "labels_per_tenant": 50_000, "clients": 8, "warm_boot_requests": 200,
                "burst_queue": 8, "burst": 64, "burst_tenants": 4, "shed_tenants": 2, "shed_burst": 16,
                "recovery_tenants": 8, "recovery_rounds": 12, "snapshot_every": 16}


def _bincount_cm(np, preds, target, c: int):
    """The (C, C) counts of the rows whose labels are both in [0, C), in int64 (numpy's reference)."""
    p, t = np.concatenate(preds) if preds else np.zeros(0, np.int64), np.concatenate(target) if target else np.zeros(0, np.int64)
    keep = (t >= 0) & (t < c) & (p >= 0) & (p < c)
    return np.bincount(t[keep] * c + p[keep], minlength=c * c).reshape(c, c)


def _digest(np, value) -> str:
    host = value.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(host).tobytes() + str(host.dtype).encode()).hexdigest()


def _served_equal(np, server, rows_of: dict, c: int):
    """Tenants whose served matrix is not bit for bit the numpy count of exactly its acked rows, and each digest."""
    bad, digests = [], {}
    for sid, rows in rows_of.items():
        want = _bincount_cm(np, [p for p, _ in rows], [t for _, t in rows], c)
        got = server.compute(sid)
        digests[sid] = _digest(np, got)
        if not np.array_equal(got.cpu().numpy(), want):
            bad.append(sid)
    return bad, digests


def _percentile(values, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))] if s else float("nan")


def _submit_until_admitted(serving, server, sid, p, t, retries: list, deadline: float):
    """Submit, honouring each ``BackpressureError``'s ``retry_after_s``; the ack, or None past ``deadline``."""
    while time.monotonic() < deadline:
        try:
            return server.submit(sid, p, t)
        except serving.BackpressureError as err:
            check(err.retry_after_s > 0.0, f"retry_after_s {err.retry_after_s}")
            retries.append(err.kind)
            time.sleep(err.retry_after_s)
    return None


def phase_metric_server(torch, np, kernel, dev, gen, smi: str, sizes=None) -> dict:
    """The serving runtime on the card: a ``MetricServer`` ingesting concurrent multi-tenant traffic.

    1. ``MetricServer(MulticlassConfusionMatrix(num_classes=1000, ignore_index=-1), capacity=256,
       queue_capacity=1024, controller=ControllerConfig(max_batch=64))`` with 256 tenants; ``warm`` with one
       request's shapes (7 buckets, 1 to 64: each bucket's step run once with every row as padding, then captured);
       the first request alone, then 200 more one at a time (the warm-boot ratio of the JAX suite's slow test);
       then 8 client threads, 32 tenants each, send the rest, one request a tenant in flight, retrying after each
       ``BackpressureError``'s ``retry_after_s``. Every ack must end ``"acked"``; every tenant's ``compute(i)`` must
       be bit for bit the numpy count of exactly its acked rows; B1's lane-batched launches must equal the
       micro-batches dispatched plus ``warm``'s 7 runs, with no eager B1 launch during the traffic; every
       dispatch of a warmed key must replay its graph (the 848-row last requests are keys ``warm`` did not see:
       their first micro-batch of a bucket captures, on the worker thread). A client thread calls ``compute(i)``
       while the worker captures the first of those; both must succeed, the capture with no failure and the value
       bit for bit a prefix of the tenant's requests.
    2. A burst of 64 requests into a second server with ``queue_capacity=8``: rejected with ``retry_after_s > 0``,
       and the rejected rows absent from the states.
    3. A shed episode on a third server with a tight SLO (5 ms at 0.95) forced through ``set_step_delay``: one
       canary admitted into the empty queue while one slow micro-batch holds the worker, the rest of the burst
       shed, the loop re-admitting on its own, and the shed rows absent from the states.
    4. ``simulate_preemption()`` then ``recover()`` on a fourth server journaling to a ``StreamSnapshotManager``:
       the restored states bit for bit with the rows acked before the kill, then streamed on to the end.

    Reports requests, micro-batches and mean live rows a micro-batch, host ms a dispatch and device ms a
    micro-batch (a CUDA event pair around ``pool.update`` on the worker), ack latency p50/p99, the first request
    after ``warm`` against the steady p99, rows/s over the traffic, shed and rejected counts, graphs and graph
    bytes.
    """
    tp = importlib.import_module("torchmetrics_tpu_torch")
    serving = importlib.import_module("torchmetrics_tpu_torch._serving")
    res = importlib.import_module("torchmetrics_tpu_torch._resilience")
    compiled = importlib.import_module("torchmetrics_tpu_torch._compile")
    obs = importlib.import_module("torchmetrics_tpu_torch._observability")
    import threading

    # the control loop's signal is the telemetry's `ingest` latencies: a server runs with telemetry on
    obs.set_telemetry_enabled(True)
    obs.set_telemetry_sampling(1)
    sizes = dict(SERVER_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    c, n_ten, rows = sizes["classes"], sizes["tenants"], sizes["rows"]
    per_tenant = sizes["labels_per_tenant"]
    chunks = -(-per_tenant // rows)
    last_rows = per_tenant - (chunks - 1) * rows
    preds, target = stream_pool_labels(torch, dev, gen, n_ten, chunks, rows, c, per_tenant)
    host_p, host_t = preds.cpu().numpy(), target.cpu().numpy()
    del preds, target

    def request(sl: int, r: int):
        n = last_rows if r == chunks - 1 else rows
        return host_p[sl, r, :n], host_t[sl, r, :n]

    def template():
        return tp.classification.MulticlassConfusionMatrix(num_classes=c, ignore_index=-1, device=dev)

    lanes_k, b1 = kernel.confusion_matrix_lanes.launches, kernel.confusion_matrix_cuda.launches
    deadline = time.monotonic() + 600.0

    # ------------------------------------------------------------ 1. the main server, then the same traffic again
    # under the JAX suite's generous objective (2 s), where queue wait no longer reads as burn
    buckets = [b for b in (1, 2, 4, 8, 16, 32, 64) if b <= sizes["max_batch"]]
    n_clients = sizes["clients"]

    def serve(cfg, race_on: bool, digests_of: dict = None):
        """The 12,544 requests through a fresh server under ``cfg``; its line, and each tenant's matrix digest."""
        obs.REGISTRY.reset()
        server = serving.MetricServer(template(), capacity=sizes["capacity"], queue_capacity=sizes["queue_capacity"],
                                      controller=cfg)
        check(server.device == dev, f"the server's device {server.device}")
        sids = [server.attach_stream() for _ in range(n_ten)]
        check(sids == list(range(n_ten)), "attach order")
        lanes_k.reset()
        b1_0 = int(b1)
        stats_0 = compiled.stats()
        t0 = time.perf_counter()
        warm = server.warm(*request(0, 0))
        warm_s = time.perf_counter() - t0
        pool = server.pool
        warm_keys = set(pool._step_fns)
        warm_lanes, warm_eager = int(lanes_k), int(b1) - b1_0
        check({k: v for k, v in warm.items() if k.endswith("stream_step")}
              == {f"{b}:stream_step": "compiled" for b in buckets}, f"warm outcomes {warm}")
        check(warm_lanes == (len(buckets) if on_card else 0), f"warm's B1 lane launches {warm_lanes}")
        check(pool.stream_update_count(0) == 0 and pool.total_row_updates == 0, "warm's masked runs changed a stream")
        if on_card:
            check(len(warm_keys) == len(buckets)
                  and all(isinstance(e, compiled.CapturedStep) for e in pool._step_fns.values()),
                  "warm did not capture a graph a bucket")
        stats_warm = compiled.stats()

        # the worker's micro-batches: host ms a dispatch, a CUDA event pair around each pool.update, live rows
        dispatch_ms, update_events, live_rows, update_host_ms = [], [], [], []
        inner_dispatch, inner_update = server._dispatch, pool.update

        def timed_dispatch(batch, sig):
            h0 = time.perf_counter()
            inner_dispatch(batch, sig)
            dispatch_ms.append((time.perf_counter() - h0) * 1e3)

        def timed_update(ids, *args, **kwargs):
            live_rows.append(int((np.asarray(ids) >= 0).sum()))
            h0 = time.perf_counter()
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                inner_update(ids, *args, **kwargs)
                end.record()
                update_events.append((start, end))
            else:
                inner_update(ids, *args, **kwargs)
            update_host_ms.append((time.perf_counter() - h0) * 1e3)

        server._dispatch, pool.update = timed_dispatch, timed_update
        # the first capture after warm (an 848-row bucket) waits for a client thread's compute(i) to be under way
        race = {"started": threading.Event(), "calling": threading.Event(), "captures": []}
        inner_capture = pool._capture

        def capture(key, step, dyn):
            c0 = time.perf_counter()
            if race_on and not race["started"].is_set():
                race["started"].set()
                race["calling"].wait(30.0)
                time.sleep(0.01)  # the reader is blocked on the server's lock, not yet at the card
            entry = inner_capture(key, step, dyn)
            race["captures"].append({"t0": c0, "t1": time.perf_counter(), "shapes": [list(s[0]) for s in key[0][2]]})
            return entry

        pool._capture = capture
        acked_rows = {sl: [] for sl in sids}
        acks, retries = [], []
        server.start()
        # warm boot: the first request alone, then warm_boot_requests more, one at a time (each tenant's request 0)
        n_boot = min(sizes["warm_boot_requests"] + 1, n_ten)
        boot_ms = []
        t_traffic = time.perf_counter()
        for sl in range(n_boot):
            p, t = request(sl, 0)
            ack = _submit_until_admitted(serving, server, sl, p, t, retries, deadline)
            check(ack is not None and ack.result(timeout=60.0) == "acked", f"warm-boot request {sl}")
            boot_ms.append(ack.latency_s * 1e3)
            acks.append(ack)
            acked_rows[sl].append((p, t))
        first_ms, steady_p99 = boot_ms[0], _percentile(boot_ms[1:], 0.99)

        reader = {}
        race_tenant = n_ten - 1
        clients_done = threading.Event()

        def read_during_capture():
            while not race["started"].wait(0.01):
                if clients_done.is_set() or time.monotonic() > deadline:
                    return
            race["calling"].set()
            r0 = time.perf_counter()
            reader["value"] = server.compute(race_tenant).cpu().numpy()
            reader["t0"], reader["t1"] = r0, time.perf_counter()

        def client(owned):
            for r in range(chunks):
                pending = []
                for sl in owned:
                    if r == 0 and sl < n_boot:
                        continue
                    p, t = request(sl, r)
                    ack = _submit_until_admitted(serving, server, sl, p, t, retries, deadline)
                    if ack is None:
                        return
                    pending.append((sl, p, t, ack))
                for sl, p, t, ack in pending:  # one request a tenant in flight
                    ack.wait(max(0.0, deadline - time.monotonic()))
                    acks.append(ack)
                    if ack.acked:
                        acked_rows[sl].append((p, t))

        threads = [threading.Thread(target=client, args=(sids[k::n_clients],), name=f"client-{k}") for k in range(n_clients)]
        reading = threading.Thread(target=read_during_capture if race_on else (lambda: None), name="reader")
        for th in threads + [reading]:
            th.start()
        for th in threads:
            th.join(max(1.0, deadline - time.monotonic()))
        clients_done.set()
        reading.join(60.0)
        check(not any(th.is_alive() for th in threads + [reading]), "a client thread did not finish")
        server.stop(drain=True)
        if on_card:
            torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t_traffic
        stats_1 = compiled.stats()
        lanes_launches, eager_traffic = int(lanes_k), int(b1) - b1_0 - warm_eager
        n_requests = n_ten * chunks
        states = [a.state for a in acks]
        check(len(acks) == n_requests and states.count("acked") == n_requests,
              f"{len(acks)} acks for {n_requests} requests, states {collections.Counter(states)}")
        check(server.batches == len(live_rows) and server.rows_applied == n_requests,
              f"{server.batches} micro-batches, {server.rows_applied} rows applied for {n_requests} requests")
        check(lanes_launches == (server.batches + len(buckets) if on_card else 0),
              f"B1 lane-batched launches {lanes_launches} for {server.batches} micro-batches and {len(buckets)} warm runs")
        check(eager_traffic == 0, f"{eager_traffic} eager B1 launches during the traffic")
        check(pool.capture_failures == {}, f"captures failed: {pool.capture_failures}")
        traffic_keys = set(pool._step_fns) - warm_keys
        captured = stats_1["captured"] - stats_warm["captured"]
        replayed = stats_1["replayed"] - stats_warm["replayed"]
        if on_card:
            check(stats_warm["captured"] - stats_0["captured"] == len(buckets), "warm's captures")
            check(captured == len(traffic_keys) == len(race["captures"]) and replayed == server.batches - captured,
                  f"{replayed} replays and {captured} captures for {server.batches} micro-batches")
            check(all(cap["shapes"][0][1] == last_rows for cap in race["captures"]),
                  f"a warmed signature captured again: {race['captures']}")
            check(all(isinstance(e, compiled.CapturedStep) for e in pool._step_fns.values()), "a step is not a graph")
        if on_card and race_on:
            # the race: the reader's compute began during the first capture and returned after it, with a good value
            first = race["captures"][0]
            check("value" in reader and first["t0"] <= reader["t0"] <= first["t1"] <= reader["t1"],
                  f"the compute did not race the capture: {reader.get('t0')} vs {first}")
            got = reader["value"]
            k = int(got.sum()) // rows
            want = _bincount_cm(np, [request(race_tenant, r)[0] for r in range(k)],
                                [request(race_tenant, r)[1] for r in range(k)], c)
            check(int(got.sum()) == k * rows and np.array_equal(got, want),
                  "the compute that raced the capture is not a prefix of its tenant's requests")
        if digests_of is None:
            mismatched, digests = _served_equal(np, server, acked_rows, c)
            check(not mismatched, f"tenants whose matrix != the numpy count of their acked rows: {mismatched[:10]}")
        else:  # the same acked rows: each tenant's matrix must be the first run's, byte for byte
            digests = {sl: _digest(np, server.compute(sl)) for sl in sids}
            check(digests == digests_of, "a tenant's matrix differs from the first run's")
        latencies = [a.latency_s * 1e3 for a in acks]
        device_ms = [s.elapsed_time(e) for s, e in update_events] if on_card else []
        graph_bytes = compiled.pool_bytes(pool._graph_pool) if on_card else 0
        line = {
            "objective": {"target_ms": cfg.target_ms, "objective": cfg.objective}, "requests": n_requests, "micro_batches": server.batches, "mean_live_rows": statistics.mean(live_rows),
            "rows_per_s": n_requests * rows / traffic_s if traffic_s else float("nan"),
            "labels_per_s": n_ten * per_tenant / traffic_s if traffic_s else float("nan"), "traffic_seconds": traffic_s,
            "host_ms_per_dispatch": {"median": statistics.median(dispatch_ms), "p99": _percentile(dispatch_ms, 0.99)},
            "host_ms_per_update": statistics.median(update_host_ms),
            "device_ms_per_micro_batch": ({"median": statistics.median(device_ms), "p99": _percentile(device_ms, 0.99)}
                                          if device_ms else None),
            "ack_ms": {"p50": _percentile(latencies, 0.5), "p99": _percentile(latencies, 0.99)},
            "warm_boot": {"first_ms": first_ms, "steady_p99_ms": steady_p99, "ratio": first_ms / steady_p99,
                          "requests": n_boot},
            "warm_seconds": warm_s, "warm_outcomes": sorted(set(warm.values())),
            "shed": retries.count("shed"), "rejected": retries.count("full"),
            "controller": {"final_target": server.controller.target,
                           "actions": dict(collections.Counter(d.action for d in server.controller.decisions()))},
            "lanes_launches": lanes_launches, "warm_lane_launches": warm_lanes, "warm_eager_b1": warm_eager,
            "graphs": {"warm": len(warm_keys), "traffic": len(traffic_keys), "replayed": replayed, "captured": captured,
                       "bytes": graph_bytes},
            "race": {"captures": len(race["captures"]), "compute_waited_ms": (reader["t1"] - reader["t0"]) * 1e3
                     if "t1" in reader else None},
        }
        server.close()
        del server, pool, acked_rows
        release_graphs(torch)
        return line, digests

    main, digests = serve(serving.ControllerConfig(max_batch=sizes["max_batch"]), race_on=True)
    lanes_launches = main["lanes_launches"]
    generous, _ = serve(serving.ControllerConfig(max_batch=sizes["max_batch"], target_ms=2000.0, objective=0.95),
                        race_on=False, digests_of=digests)

    # ------------------------------------------------------------ 2. backpressure: a burst into a queue of 8
    obs.REGISTRY.reset()  # each server's control loop reads only its own latencies
    lanes_2 = int(lanes_k)
    burst_srv = serving.MetricServer(template(), capacity=sizes["burst_tenants"], queue_capacity=sizes["burst_queue"],
                                     controller=serving.ControllerConfig(max_batch=sizes["max_batch"]))
    b_ids = [burst_srv.attach_stream() for _ in range(sizes["burst_tenants"])]
    burst_srv.warm(*request(0, 0))
    kept = {sl: [] for sl in b_ids}
    b_acks, hints = [], []
    with burst_srv:
        burst_srv.set_step_delay(0.05)
        for k in range(sizes["burst"]):
            sl = b_ids[k % len(b_ids)]
            p, t = request(k % n_ten, (1 + k // n_ten) % chunks)
            try:
                b_acks.append(burst_srv.submit(sl, p, t))
                kept[sl].append((p, t))
            except serving.BackpressureError as err:
                hints.append((err.kind, err.retry_after_s))
        burst_srv.set_step_delay(0.0)
        check(all(a.result(timeout=60.0) == "acked" for a in b_acks), "a burst request that was admitted failed")
        check(hints and all(kind == "full" and hint > 0.0 for kind, hint in hints),
              f"the burst was not pushed back with retry hints: {hints[:4]}")
        bad, _ = _served_equal(np, burst_srv, kept, c)
        check(not bad, f"burst tenants whose matrix holds rows that were rejected: {bad}")
    burst = {"sent": sizes["burst"], "admitted": len(b_acks), "rejected": len(hints),
             "retry_after_s": {"min": min(h for _, h in hints), "max": max(h for _, h in hints)},
             "queue_capacity": sizes["burst_queue"]}
    del burst_srv
    release_graphs(torch)

    # ------------------------------------------------------------ 3. a shed episode under a tight SLO
    obs.REGISTRY.reset()
    cfg = serving.ControllerConfig(min_batch=1, max_batch=8, interval_s=0.01, target_ms=5.0, objective=0.95)
    shed_srv = serving.MetricServer(template(), capacity=sizes["shed_tenants"], queue_capacity=32, controller=cfg)
    s_ids = [shed_srv.attach_stream() for _ in range(sizes["shed_tenants"])]
    shed_srv.warm(*request(0, 0))
    s_kept = {sl: [] for sl in s_ids}
    shed_retries, sent = [], 0

    def send(sl):
        nonlocal sent
        p, t = request(sent % n_ten, (2 + sent // n_ten) % chunks)
        sent += 1
        ack = _submit_until_admitted(serving, shed_srv, sl, p, t, shed_retries, deadline)
        check(ack is not None and ack.result(timeout=60.0) == "acked", "a shed-phase request failed")
        s_kept[sl].append((p, t))

    with shed_srv:
        shed_srv.set_step_delay(0.03)
        while not shed_srv.queue.shedding and time.monotonic() < deadline:  # the ingress edge applies the decision
            send(s_ids[sent % len(s_ids)])
        check(shed_srv.queue.shedding, "the burn never tripped the shed law")
        # one slow micro-batch holds the worker: the queue is empty, the next arrival is the canary, the rest shed
        shed_srv.set_step_delay(1.0)
        p, t = request(0, 3 % chunks)
        slow = _submit_until_admitted(serving, shed_srv, s_ids[0], p, t, shed_retries, deadline)
        while shed_srv.queue.depth and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.05)  # the worker is past assembling its micro-batch, inside the slow dispatch
        admitted, shed_kinds = [], []
        for k in range(sizes["shed_burst"]):
            sl = s_ids[k % len(s_ids)]
            bp, bt = request(k % n_ten, 4 % chunks)
            try:
                admitted.append((sl, bp, bt, shed_srv.submit(sl, bp, bt)))
            except serving.BackpressureError as err:
                shed_kinds.append(err.kind)
        shed_srv.set_step_delay(0.0)
        check(len(admitted) == 1 and shed_kinds == ["shed"] * (sizes["shed_burst"] - 1),
              f"a shed episode admitted {len(admitted)} of {sizes['shed_burst']} ({shed_kinds})")
        check(slow.result(timeout=60.0) == "acked", "the slow request")
        s_kept[s_ids[0]].append((p, t))
        for sl, bp, bt, ack in admitted:
            check(ack.result(timeout=60.0) == "acked", "the canary")
            s_kept[sl].append((bp, bt))
        while (shed_srv.controller.shedding or shed_srv.controller.burn_rate() >= 1.0) and time.monotonic() < deadline:
            send(s_ids[sent % len(s_ids)])
        check(not shed_srv.controller.shedding, "the loop never re-admitted")
        bad, _ = _served_equal(np, shed_srv, s_kept, c)
        check(not bad, f"shed-phase tenants whose matrix holds a shed row: {bad}")
        shed = {"episodes": shed_srv.queue.shed_episodes, "canary_admitted": len(admitted),
                "burst_shed": len(shed_kinds), "requests_acked": sum(len(v) for v in s_kept.values()),
                "retries": dict(collections.Counter(shed_retries)),
                "actions": dict(collections.Counter(d.action for d in shed_srv.controller.decisions()))}
    del shed_srv
    release_graphs(torch)

    # ------------------------------------------------------------ 4. preemption and recovery from the journal
    obs.REGISTRY.reset()
    with tempfile.TemporaryDirectory() as folder:
        rec_srv = serving.MetricServer(
            template(), capacity=sizes["recovery_tenants"], queue_capacity=64,
            controller=serving.ControllerConfig(max_batch=sizes["recovery_tenants"]), snapshot_dir=folder,
            snapshot_policy=res.SnapshotPolicy(every_n_updates=sizes["snapshot_every"], journal_max_entries=1024,
                                               async_write=False))
        r_ids = [rec_srv.attach_stream() for _ in range(sizes["recovery_tenants"])]
        rec_srv.warm(*request(0, 0))
        r_kept = {sl: [] for sl in r_ids}
        r_lat, after_lat = [], []
        rec_srv.start()
        half = sizes["recovery_rounds"] // 2
        for r in range(sizes["recovery_rounds"]):
            if r == half:
                rec_srv.simulate_preemption()
                report, recovery_ms = rec_srv.recover()
                check(not report.truncated_journal, f"restore: {report}")
                bad, _ = _served_equal(np, rec_srv, r_kept, c)
                check(not bad, f"restored tenants != their rows acked before the kill: {bad}")
            round_acks = []
            for sl in r_ids:
                p, t = request(sl, (5 + r) % chunks)
                round_acks.append((sl, p, t, _submit_until_admitted(serving, rec_srv, sl, p, t, [], deadline)))
            for sl, p, t, ack in round_acks:
                check(ack is not None and ack.result(timeout=60.0) == "acked", "a recovery-phase request")
                r_kept[sl].append((p, t))
                (after_lat if r == half else r_lat).append(ack.latency_s * 1e3)
        rec_srv.stop(drain=True)
        bad, _ = _served_equal(np, rec_srv, r_kept, c)
        check(not bad, f"tenants != their acked rows after the recovery: {bad}")
        recovery = {"generation": report.generation, "replayed": report.replayed, "recovery_ms": recovery_ms,
                    "first_round_after_ms": {"max": max(after_lat), "median": statistics.median(after_lat)},
                    "steady_ms": {"median": statistics.median(r_lat), "p99": _percentile(r_lat, 0.99)},
                    "tenants": len(r_ids), "rounds": sizes["recovery_rounds"], "killed_after_round": half}
        rec_srv.close()
        del rec_srv
    release_graphs(torch)
    other_lanes = int(lanes_k) - lanes_2

    # B1's lane-batched kernel against its plain version at the server's bucket shapes
    lane_err, lane_shapes = 0.0, []
    for bucket, n in ((1, rows), (sizes["max_batch"], rows), (8, last_rows), (sizes["max_batch"], last_rows)):
        lane_rows = [request(k % n_ten, 0 if n == rows else chunks - 1) for k in range(bucket)]
        p = torch.as_tensor(np.stack([lp for lp, _ in lane_rows]), device=dev)
        t = torch.as_tensor(np.stack([lt for _, lt in lane_rows]), device=dev)
        valid = t != -1
        got_lanes = kernel.confusion_matrix_lanes(p, t, c, valid)
        want_lanes = kernel.confusion_matrix_lanes_plain(p, t, c, valid)
        check(torch.equal(got_lanes, want_lanes), f"the lane-batched kernel != its plain version at ({bucket}, {n})")
        lane_err = max(lane_err, float((got_lanes.double() - want_lanes.double()).abs().max()))
        lane_shapes.append([bucket, n, c])
    seconds = time.perf_counter() - t_phase
    out = {
        "phase": "metric_server", "classes": c, "tenants": n_ten, "capacity": sizes["capacity"],
        "queue_capacity": sizes["queue_capacity"], "max_batch": sizes["max_batch"], "clients": n_clients,
        "request_rows": [rows, last_rows], "main": main, "generous_objective": generous, "burst": burst, "shed": shed, "recovery": recovery,
        "lanes_launches": lanes_launches, "other_server_lane_launches": other_lanes,
        "lane_check": {"shapes": lane_shapes, "max_abs_err": lane_err},
        "tolerance": {"counts": "exact"}, "seconds": seconds, "card": smi,
    }
    obs.set_telemetry_enabled(False)
    obs.set_telemetry_sampling(obs.state.DEFAULT_SAMPLE_EVERY)
    obs.REGISTRY.reset()
    obs.BUS.clear()
    emit(out)
    return out


# ------------------------------------------------------------------ fleet_rollup
FLEET_SIZES = {"classes": 1000, "branching": (8, 8), "epochs": 4, "updates": 2, "rows": 1024,
               "chaos_branching": (4, 4), "race_rows": 512, "store_branching": (2, 2), "store_epochs": 2,
               "timing_reps": 5}


def _host_only_states(states) -> bool:
    """True when a decoded contribution's states hold no tensor, at any depth."""
    tensor = importlib.import_module("torch").Tensor
    if isinstance(states, tensor):
        return False
    if isinstance(states, dict):
        return all(_host_only_states(v) for v in states.values())
    if isinstance(states, (list, tuple)):
        return all(_host_only_states(v) for v in states)
    return True


def _fleet_counts(np, labels, c: int):
    """The numpy confusion matrix of ``[(preds, target), ...]`` host arrays."""
    flat = np.concatenate([t.astype(np.int64) * c + p for p, t in labels])
    return np.bincount(flat, minlength=c * c).reshape(c, c)


def phase_fleet_rollup(torch, np, kernel, dev, gen, smi: str, sizes=None) -> dict:
    """Fleet aggregation (``_fleet``) with its edge metrics on the card.

    1. ``FleetTree.build(MulticlassConfusionMatrix(num_classes=1000), branching=(8, 8))`` on the card over
       ``InProcessKV`` with the default 2.0 s deadline: 1 global node, 8 regions, 64 edges. 4 epochs; each
       edge takes 2 updates of 1,024 labels drawn on the card, then ``run_epoch(e)``; ``join_pending`` after
       the last. The root's matrix must be bit for bit a numpy ``bincount`` of every label fed, each region's
       of its 8 edges' labels; every rollup full, 256 ``(edge, epoch)`` sources at the root, no duplicate or
       quarantine; every node's states CUDA tensors on the card; every contribution decoded by a fold holds
       no tensor; B1 rises by exactly 512 (the edge updates; the rollups launch none), each edge captures one
       graph; no publisher thread alive after ``join_pending``. A template that has captured its update
       clones into metrics with no graph and their own storage. Reports host ms to encode and to decode and
       fold one contribution, wire bytes an epoch, ms an epoch at each level, the root's staleness and the
       peak card memory.
    2. ``run_fleet_chaos`` with the same 1,000-class template on the card, the JAX spec's schedule and
       ``branching=(4, 4)``, each chaos update one batch of 1,024 labels; ``deadline_s`` raised from the
       JAX spec's 0.25 s only where the measured encode needs it (the straggler's stall, 4 deadlines, must
       outlast the other 15 edges' encodes and its region's deadline). ``result.ok`` must hold, with a
       duplicate dropped, the corrupt payload quarantined, a late fold and a dump a degradation event.
    3. An asynchronous publish whose retries are exhausted while another edge captures a new signature:
       the capture must succeed inside the send's retry window, and the failed delta must fold at the next
       epoch (bit for bit against numpy).
    4. ``CoordinationServiceKV`` over a world-1 ``TCPStore`` on 127.0.0.1: a ``(2, 2)`` tree for 2 epochs,
       bit for bit with the same rows through ``InProcessKV``; ``CoordinationServiceKV()`` with no store and
       no process group raises.
    """
    import threading

    tp = importlib.import_module("torchmetrics_tpu_torch")
    fleet = importlib.import_module("torchmetrics_tpu_torch._fleet")
    fnode = importlib.import_module("torchmetrics_tpu_torch._fleet.node")
    compiled = importlib.import_module("torchmetrics_tpu_torch._compile")
    policy = importlib.import_module("torchmetrics_tpu_torch._resilience.policy")
    import torch.distributed as dist

    sizes = dict(FLEET_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    c, rows, epochs, updates = sizes["classes"], sizes["rows"], sizes["epochs"], sizes["updates"]
    b1 = kernel.confusion_matrix_cuda.launches

    def template():
        return tp.classification.MulticlassConfusionMatrix(num_classes=c, device=dev)

    def on_dev(m) -> bool:
        return all(isinstance(getattr(m, n), torch.Tensor) and getattr(m, n).device == dev for n in m._defaults)

    # every contribution a fold decodes: host values only
    decoded = {"n": 0, "host_only": True}
    inner_decode = fnode.decode_contribution

    def checked_decode(blob):
        contrib = inner_decode(blob)
        decoded["n"] += 1
        decoded["host_only"] &= _host_only_states(contrib.states)
        return contrib

    fnode.decode_contribution = checked_decode
    try:
        # ------------------------------------------------ 0. a template that has captured clones safely
        b1.reset()
        captured = template()
        p0 = torch.randint(0, c, (rows,), generator=gen, device=dev)
        for _ in range(3):  # eager, the capture, a replay
            captured.update(p0, p0)
        twin = captured.clone()
        graph_ptrs = set()
        for entry in captured.__dict__.get("_auto_update_fn", {}).values():
            graph_ptrs |= {b.data_ptr() for b in getattr(entry, "bufs", {}).values() if isinstance(b, torch.Tensor)}
        check(not twin.__dict__.get("_auto_update_fn") and twin.confmat.data_ptr() not in graph_ptrs
              and torch.equal(twin.confmat, captured.confmat), "a clone of a captured metric kept its graph or storage")
        if on_card:
            check(bool(graph_ptrs) and captured.confmat.data_ptr() in graph_ptrs, "the template did not capture")
        clone_b1 = int(b1)
        check(clone_b1 == (3 if on_card else 0), f"B1 launches of the captured template {clone_b1}")
        del captured, twin

        # ------------------------------------------------ 1. the main traffic: (8, 8) tree, 4 epochs
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mem_0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        tree = fleet.FleetTree.build(template(), branching=sizes["branching"])
        build_s = time.perf_counter() - t0
        leaves = tree.leaves
        n_leaves = len(leaves)
        check(n_leaves == int(np.prod(sizes["branching"])) and len(tree.nodes) == 1 + sizes["branching"][0] + n_leaves,
              f"tree shape {[len(level) for level in tree.levels]}")
        check(all(on_dev(m) for node in tree.nodes.values() for m in (node.metric, node._template, node._pending_delta)),
              "a node's states are not on the template's card")
        mem_tree = (torch.cuda.memory_allocated() - mem_0) if on_card else 0
        preds = torch.randint(0, c, (epochs, n_leaves, updates, rows), generator=gen, device=dev)
        target = torch.randint(0, c, (epochs, n_leaves, updates, rows), generator=gen, device=dev)
        host_p, host_t = preds.cpu().numpy(), target.cpu().numpy()

        # wire bytes, and host ms a level, through the tree's own calls
        wire = {"bytes": 0, "sets": 0}
        inner_set = tree.kv.set

        def counted_set(key, blob):
            wire["bytes"] += len(blob)
            wire["sets"] += 1
            inner_set(key, blob)

        tree.kv.set = counted_set
        level_ms = {"edge": 0.0, "region": 0.0, "global": 0.0}
        level_of = {n.node_id: ("edge" if not n.children else "global" if n is tree.root else "region")
                    for n in tree.nodes.values()}
        inner_rollup, inner_publish = fleet.AggregationNode.rollup, fleet.AggregationNode.publish_async

        def timed(inner):
            def call(self, epoch):
                h0 = time.perf_counter()
                try:
                    return inner(self, epoch)
                finally:
                    level_ms[level_of.get(self.node_id, "edge")] += (time.perf_counter() - h0) * 1e3
            return call

        receipts = []
        fleet.AggregationNode.rollup = timed(inner_rollup)
        fleet.AggregationNode.publish_async = timed(inner_publish)
        b1.reset()
        stats_0 = compiled.stats()
        per_epoch = []
        try:
            for e in range(epochs):
                for k in level_ms:
                    level_ms[k] = 0.0
                wire_0 = wire["bytes"]
                h0 = time.perf_counter()
                for i, leaf in enumerate(leaves):
                    for u in range(updates):
                        leaf.update(preds[e, i, u], target[e, i, u])
                if on_card:
                    torch.cuda.synchronize()
                update_ms = (time.perf_counter() - h0) * 1e3
                b1_updates = int(b1)
                h1 = time.perf_counter()
                root_r = tree.run_epoch(e)
                if on_card:
                    torch.cuda.synchronize()
                epoch_ms = (time.perf_counter() - h1) * 1e3
                check(int(b1) == b1_updates == ((e + 1) * n_leaves * updates if on_card else 0),
                      f"B1 at epoch {e}: {b1_updates} after the updates, {int(b1)} after the rollups")
                receipts += [n.last_rollup for n in tree.nodes.values() if n.children]
                per_epoch.append({
                    "epoch": e, "updates_ms": update_ms, "run_epoch_ms": epoch_ms,
                    "edge_publish_ms": level_ms["edge"], "region_rollup_publish_ms": level_ms["region"],
                    "root_rollup_ms": level_ms["global"], "wire_bytes": wire["bytes"] - wire_0,
                    "root_staleness_ms": root_r.staleness_ms, "root_latency_ms": root_r.latency_ms,
                })
            tree.join_pending(timeout=30.0)
        finally:
            fleet.AggregationNode.rollup, fleet.AggregationNode.publish_async = inner_rollup, inner_publish
        stats_1 = compiled.stats()
        peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
        check(not [t for t in threading.enumerate() if t.name.startswith("fleet-publish-") and t.is_alive()],
              "a publisher thread outlived join_pending")
        b1_main = int(b1)
        check(b1_main == (epochs * n_leaves * updates if on_card else 0), f"B1 launches {b1_main} (512 on the card)")
        captures = stats_1["captured"] - stats_0["captured"]
        if on_card:
            check(captures == n_leaves, f"{captures} captures for {n_leaves} edges")
            check(all(len(leaf.metric.__dict__.get("_auto_update_fn", {})) == 1 and _engaged(leaf.metric)
                      and all(isinstance(x, compiled.CapturedStep) for x in leaf.metric._auto_update_fn.values())
                      for leaf in leaves), "an edge did not capture exactly one graph")
        check(all(not r.partial for r in receipts), f"partial rollups: {[r.describe() for r in receipts if r.partial]}")
        check(sum(r.duplicates_dropped + r.corrupt_quarantined for r in receipts) == 0, "a duplicate or quarantine")
        want_sources = {(leaf.node_id, e) for leaf in leaves for e in range(epochs)}
        check(tree.root.folded_sources == want_sources, f"root sources {len(tree.root.folded_sources)}")
        check(all(on_dev(m) for node in tree.nodes.values() for m in (node.metric, node._template, node._pending_delta)),
              "a node's states left the card")
        check(decoded["host_only"] and decoded["n"] == epochs * (n_leaves + sizes["branching"][0]),
              f"contributions decoded {decoded['n']}, host only {decoded['host_only']}")
        labels_of = {leaf.node_id: [(host_p[e, i, u], host_t[e, i, u]) for e in range(epochs) for u in range(updates)]
                     for i, leaf in enumerate(leaves)}
        check(np.array_equal(tree.root.metric.confmat.cpu().numpy(),
                             _fleet_counts(np, [x for v in labels_of.values() for x in v], c)), "root != numpy")
        for region in tree.levels[1]:
            check(np.array_equal(region.metric.confmat.cpu().numpy(),
                                 _fleet_counts(np, [x for cid in region.children for x in labels_of[cid]], c)),
                  f"{region.node_id} != numpy")

        # one contribution's host costs at this width, on a full region's accumulator
        region = tree.levels[1][0]
        reps = sizes["timing_reps"]
        enc_ms, fold_ms = [], []
        scratch_acc = template()
        for r in range(reps):
            h0 = time.perf_counter()
            blob, _ = fleet.encode_contribution(region.metric, region.node_id, 100 + r, ())
            enc_ms.append((time.perf_counter() - h0) * 1e3)
            h0 = time.perf_counter()
            scratch_acc.merge_state(region._verified_scratch(inner_decode(blob)))
            if on_card:
                torch.cuda.synchronize()
            fold_ms.append((time.perf_counter() - h0) * 1e3)
        check(torch.equal(scratch_acc.confmat, region.metric.confmat * reps), "the timed folds disagree")
        encode_ms, decode_fold_ms = statistics.median(enc_ms), statistics.median(fold_ms)
        main = {
            "tree": [len(level) for level in tree.levels], "build_s": build_s, "tree_state_bytes": mem_tree,
            "b1_launches": b1_main, "captures": captures, "contributions_decoded": decoded["n"],
            "per_epoch": per_epoch, "wire_bytes_per_epoch": statistics.median(p["wire_bytes"] for p in per_epoch),
            "encode_ms": encode_ms, "decode_fold_ms": decode_fold_ms, "contribution_bytes": len(blob),
            "root_staleness_ms_max": max(p["root_staleness_ms"] for p in per_epoch),
            "peak_bytes": peak_bytes,
        }
        del tree, scratch_acc, region, preds, target
        release_graphs(torch)

        # ------------------------------------------------ 2. chaos on the card
        b1.reset()
        chaos_deadline = max(0.25, 10.0 * encode_ms / 1e3)

        def make_update(rng):
            return (torch.as_tensor(rng.integers(0, c, rows), device=dev),
                    torch.as_tensor(rng.integers(0, c, rows), device=dev))

        spec = fleet.FleetChaosSpec(branching=sizes["chaos_branching"], deadline_s=chaos_deadline)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fleet.run_fleet_chaos(template(), make_update, spec)
        check(result.ok, f"fleet chaos: {result.describe()}")
        check(result.duplicates_dropped >= 1 and result.corrupt_quarantined == 1 and result.late_folds >= 1
              and result.partial_rollups >= 3 and result.dumps_match_events
              and all(result.events_by_kind.get(k, 0) >= 1
                      for k in ("fleet_partial", "fleet_corrupt", "fleet_publish_degraded")),
              f"fleet chaos ledger: {result.describe()}")
        chaos = {"describe": result.describe(), "deadline_s": chaos_deadline,
                 "deadline_rule": "max(0.25, 10 x encode_ms): the stall (4 deadlines) outlasts 15 encodes and a deadline",
                 "elapsed_s": result.elapsed_s, "b1_launches": int(b1), "max_staleness_ms": result.max_staleness_ms}
        release_graphs(torch)

        # ------------------------------------------------ 3. an exhausted async publish during a capture
        b1.reset()
        stats_0 = compiled.stats()
        kv = fleet.InProcessKV()
        slow = policy.RetryPolicy(max_retries=2, backoff_base=0.2, backoff_factor=1.0, backoff_max=0.2)
        tpl = template()
        a = fleet.AggregationNode("edge-a", tpl, kv, namespace="race", retry=slow)
        bn = fleet.AggregationNode("edge-b", tpl, kv, namespace="race", retry=slow)
        parent = fleet.AggregationNode("region-r", tpl, kv, children=("edge-a", "edge-b"), namespace="race",
                                       deadline_s=0.2, retry=slow)
        fed = {"edge-a": [], "edge-b": []}

        def feed(node, n):
            p = torch.randint(0, c, (n,), generator=gen, device=dev)
            t = torch.randint(0, c, (n,), generator=gen, device=dev)
            node.update(p, t)
            fed[node.node_id].append((p.cpu().numpy(), t.cpu().numpy()))

        for _ in range(3):
            feed(a, rows)  # eager, capture, replay
        feed(bn, sizes["race_rows"])  # b's new signature: eager
        kv.fail_publishes(slow.attempts)
        sender = a.publish_async(0)
        alive_before = sender.is_alive()
        c0 = time.perf_counter()
        feed(bn, sizes["race_rows"])  # b's capture, while a's send retries on its thread
        if on_card:
            torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - c0) * 1e3
        alive_after = sender.is_alive()
        check(alive_before and alive_after, "the capture did not run inside the send's retry window")
        sender.join(10.0)
        check(bn.publish(0), "edge-b's publish after the failed send")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r0 = parent.rollup(0)
        check(a.publish_failures == 1 and r0.partial and r0.missing == ("edge-a",), f"epoch 0: {r0.describe()}")
        if on_card:
            check(_engaged(bn.metric) and len(bn.metric._auto_update_fn) == 1
                  and all(isinstance(x, compiled.CapturedStep) for x in bn.metric._auto_update_fn.values()),
                  f"the capture did not survive: {bn.metric._auto_disabled_reason}")
            check(compiled.stats()["captured"] - stats_0["captured"] == 2, "captures in the race")
        feed(a, rows)
        feed(bn, sizes["race_rows"])  # b's replay
        check(a.publish(1) and bn.publish(1), "epoch 1 publishes")
        r1 = parent.rollup(1)
        check(not r1.partial and set(r1.sources) == {("edge-a", 0), ("edge-a", 1), ("edge-b", 1)},
              f"epoch 1: {r1.describe()}")
        check(np.array_equal(parent.metric.confmat.cpu().numpy(),
                             _fleet_counts(np, fed["edge-a"] + fed["edge-b"], c)), "race parent != numpy")
        race = {"capture_ms": capture_ms, "b1_launches": int(b1), "rollups": [r0.describe(), r1.describe()]}
        check(race["b1_launches"] == (7 if on_card else 0), f"race B1 launches {race['b1_launches']}")
        del kv, a, bn, parent, tpl
        release_graphs(torch)

        # ------------------------------------------------ 4. CoordinationServiceKV over a TCPStore
        b1.reset()
        store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
        api = {name: hasattr(store, name) for name in ("set", "check", "get", "list_keys", "delete_key", "multi_get")}
        sb, se = sizes["store_branching"], sizes["store_epochs"]
        n_store = int(np.prod(sb))
        sp = torch.randint(0, c, (se, n_store, updates, rows), generator=gen, device=dev)
        st = torch.randint(0, c, (se, n_store, updates, rows), generator=gen, device=dev)

        def drive(kv):
            t = fleet.FleetTree.build(template(), sb, kv=kv, namespace="store")
            out = []
            for e in range(se):
                for i, leaf in enumerate(t.leaves):
                    for u in range(updates):
                        leaf.update(sp[e, i, u], st[e, i, u])
                out.append(t.run_epoch(e))
                out += [t.nodes[n.node_id].last_rollup for n in t.levels[1]]
            t.join_pending(timeout=30.0)
            return t, [(r.node_id, r.contributing, r.missing, r.sources, r.partial, r.rows_folded) for r in out]

        h0 = time.perf_counter()
        got, got_r = drive(fleet.CoordinationServiceKV(store=store, poll_s=0.005))
        store_s = time.perf_counter() - h0
        want, want_r = drive(fleet.InProcessKV())
        check(got_r == want_r and all(not r[4] for r in got_r), "the store tree's receipts differ")
        check(all(torch.equal(got.nodes[n].metric.confmat, want.nodes[n].metric.confmat) for n in want.nodes
                  if want.nodes[n].children), "the store tree is not bit for bit the in-process tree")
        check(not [k for k in store.list_keys() if k.startswith("tm_tpu/")], "folded keys left in the store")
        check(not dist.is_initialized(), "a process group exists")
        try:
            fleet.CoordinationServiceKV()
            raised = False
        except RuntimeError:
            raised = True
        check(raised, "CoordinationServiceKV() without a store or a process group did not raise")
        store_line = {"api": api, "seconds": store_s, "b1_launches": int(b1), "tree": [len(level) for level in got.levels]}
        del got, want, store, sp, st
        release_graphs(torch)
    finally:
        fnode.decode_contribution = inner_decode

    out = {"phase": "fleet_rollup", "classes": c, "main": main, "chaos": chaos, "race": race, "store": store_line,
           "b1_launches": clone_b1 + main["b1_launches"] + chaos["b1_launches"] + race["b1_launches"]
           + store_line["b1_launches"],
           "seconds": time.perf_counter() - t_phase, "torch": torch.__version__, "device_power": smi}
    emit(out)
    return out


# ------------------------------------------------------------------ aot_cold_start
AOT_SIZES = {"classes": 1000, "batch": 1024, "updates": 3, "lanes": 64, "pool_steps": 2, "rows": 8,
             "engine_steps": 2}
AOT_LIBRARIES = ("confmat", "conv_epilogue", "lpips_head", "attention", "layernorm_residual", "biquad")

# one child process of phase 57: its cache is TM_TPU_AOT_CACHE, its build directory argv[2]
_AOT_CHILD = r"""
import time
t_start = time.perf_counter()
import json, sys
t_epoch = time.time()
sys.path.insert(0, sys.argv[1])
import chip_smoke
out = chip_smoke.aot_child(sys.argv[2], sys.argv[3], int(sys.argv[4]), json.loads(sys.argv[5]), t_start)
out["t_start_epoch"] = t_epoch
print(json.dumps(out))
"""


def _aot_small_launches(torch, np, ce, lh, ka, kb, dev, gen) -> dict:
    """B2a, B2b, B3, B4, B5 and S1 once each at a small shape, each against its plain version at the tolerance
    of its own phase (7, 8, 12, 13, 44); the worst absolute error of each."""
    srmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    errs = {}
    # B2a: Mixed_5b's 1x1 branch (192 -> 64) on a 35x35 map of 4 images, bf16
    x = rand(4 * 35 * 35, 192).relu_().bfloat16()
    w = (rand(64, 192) / 192**0.5).bfloat16()
    bias = (0.1 * rand(64)).bfloat16()
    got, ref = ce.matmul_bias_relu(x, w, bias), ce.matmul_bias_relu_plain(x, w, bias)
    err = (got.float() - ref.float()).abs()
    check(bool((err <= GEMM_BF16_ULP * ref.float().abs() + GEMM_F32_RTOL * float(ref.float().abs().max())).all()),
          f"B2a: max abs err {float(err.max())} against its plain version")
    errs["B2a"] = float(err.max())
    # B2b: bias + ReLU in place on the same map's conv output, bf16
    y = rand(4 * 35 * 35, 64).bfloat16()
    got, ref = ce.bias_relu_(y.clone(), bias), ce.bias_relu_plain(y, bias)
    check(torch.equal(got, ref), "B2b differs from its plain version")
    errs["B2b"] = float((got.float() - ref.float()).abs().max())
    # B3: alex's third tap (13x13, 384 channels), 4 pairs of bf16 maps
    f0 = rand(4, 13, 13, 384).relu_().bfloat16()
    f1 = (f0.float() + 0.3 * rand(4, 13, 13, 384)).relu_().bfloat16()
    wt = torch.rand(384, generator=gen, device=dev)
    got, ref = lh.lpips_head(f0, f1, wt), lh.lpips_head_plain(f0, f1, wt)
    err = (got - ref).abs()
    check(bool((err <= HEAD_RTOL * ref.abs() + 1e-7).all()), f"B3: max abs err {float(err.max())}")
    errs["B3"] = float(err.max())
    # B4: BERT-base's heads (768 = 12 x 64) on 2 sequences of 37 tokens, the second half masked, float32
    q, k, v = rand(2, 37, 768), rand(2, 37, 768), rand(2, 37, 768)
    mask = torch.ones((2, 37), device=dev)
    mask[1, 19:] = 0
    got, ref = ka.attention(q, k, v, mask, num_heads=12), ka.attention_plain(q, k, v, mask, num_heads=12)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= ATT_F32_RTOL * scale, f"B4: max abs err {err} at scale {scale}")
    errs["B4"] = err
    # B5: LayerNorm(x + h) at BERT-base's width, 74 rows, float32
    scale_w, shift = torch.rand(768, generator=gen, device=dev) + 0.5, 0.1 * rand(768)
    got = ka.layernorm_residual(q.view(-1, 768), k.view(-1, 768), scale_w, shift, eps=1e-12)
    ref = ka.layernorm_residual_plain(q.view(-1, 768), k.view(-1, 768), scale_w, shift, eps=1e-12)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= LN_RTOL * scale, f"B5: max abs err {err} at scale {scale}")
    errs["B5"] = err
    # S1: SRMR's 23 gammatone channels on 2 rows of 4,000 samples, bit for bit with the plain loop
    num, den, gain = (torch.from_numpy(a.astype(np.float32)) for a in srmr._gammatone_coefs(16_000, 23, 125.0))
    rows = rand(2, 4000)
    got, ref = kb.biquad_bank(rows, num, den, gain), kb.biquad_bank_plain(rows, num, den, gain)
    check(torch.equal(got, ref), f"S1: max abs err {float((got - ref).abs().max())} against its plain loop")
    errs["S1"] = float((got - ref).abs().max())
    return errs


def aot_child(device: str, build_dir: str, seed: int, sizes: dict, t_start: float) -> dict:
    """One process of phase 57 (run by ``_AOT_CHILD``): libraries, the metric, the pool, the engine, the small
    launches; every state checked bit for bit against numpy here. Returns its JSON line."""
    from pathlib import Path

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.utilities import nvcc

    nvcc.BUILD_DIR = Path(build_dir)
    from torchmetrics_tpu_torch import _compile
    from torchmetrics_tpu_torch._aot import aot_stats
    from torchmetrics_tpu_torch._spmd import build_mesh
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix

    kernel = importlib.import_module("torchmetrics_tpu_torch.functional.classification._confmat_kernel")
    ce = importlib.import_module("torchmetrics_tpu_torch._kernels.conv_epilogue")
    lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")
    ka = importlib.import_module("torchmetrics_tpu_torch._kernels.attention")
    kb = importlib.import_module("torchmetrics_tpu_torch._kernels.biquad")
    t_import = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    t_cuda = time.perf_counter()

    # the six CUDA libraries: one nvcc each at once where the cache cannot supply them
    loaders = dict(zip(AOT_LIBRARIES, (
        (kernel.SOURCE, kernel._library), (ce.SOURCE, ce._library), (lh.SOURCE, lh._library),
        (ka.ATTENTION_SOURCE, ka._attention_library), (ka.LAYERNORM_SOURCE, ka._layernorm_library),
        (kb.SOURCE, kb._library),
    ))) if on_card else {}
    infos = dict(zip(loaders, nvcc.build_all([source for source, _ in loaders.values()])))
    for _, load in loaders.values():
        load()
    t_libs = time.perf_counter()
    lib_stats = aot_stats()

    c, batch = sizes["classes"], sizes["batch"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *shape: torch.randint(0, c, shape, generator=gen, device=dev)  # noqa: E731
    b1, lanes_k = kernel.confusion_matrix_cuda.launches, kernel.confusion_matrix_lanes.launches
    b1.reset()
    lanes_k.reset()

    def counts(preds, target):
        flat = target.cpu().numpy().astype(np.int64).reshape(-1) * c + preds.cpu().numpy().reshape(-1)
        return np.bincount(flat, minlength=c * c).reshape(c, c)

    digests = {}

    def same(name, got, want):
        got = got.cpu().numpy()
        check(got.dtype.kind == "i" and np.array_equal(got, want), f"{name} differs from numpy's bincount")
        digests[name] = hashlib.sha256(got.tobytes()).hexdigest()

    # 1. the metric: precompile, then its updates (the first of them the first replay)
    mp, mt = draw(sizes["updates"], batch), draw(sizes["updates"], batch)
    metric = MulticlassConfusionMatrix(num_classes=c, device=dev)
    s0, cap0 = aot_stats(), _compile.stats()["capture_seconds"]
    t0 = time.perf_counter()
    report = metric.precompile(mp[0], mt[0])
    t_pre = time.perf_counter()
    s1, cap1 = aot_stats(), _compile.stats()["capture_seconds"]
    metric.update(mp[0], mt[0])
    if on_card:
        torch.cuda.synchronize()
    t_replay = time.perf_counter()
    check(report["engaged"], f"precompile did not engage: {report}")
    for i in range(1, sizes["updates"]):
        metric.update(mp[i], mt[i])
    want = counts(mp, mt)
    same("metric_state", metric.confmat, want)
    same("metric_compute", metric.compute(), want)
    metric_b1 = int(b1)
    check(metric_b1 == (1 + sizes["updates"] if on_card else 0),
          f"B1 {metric_b1} launches for a precompile and {sizes['updates']} updates")

    # 2. a pool of 64 lanes of the metric
    lanes, per_lane = sizes["lanes"], batch // sizes["lanes"]
    pool = MulticlassConfusionMatrix(num_classes=c, device=dev).to_stream_pool(capacity=lanes)
    ids = [pool.attach() for _ in range(lanes)]
    steps = [(draw(lanes, per_lane), draw(lanes, per_lane)) for _ in range(sizes["pool_steps"])]
    pool_out = pool.warm_start(ids, *steps[0])
    for p, t in steps:
        pool.update(ids, p, t)
    values = pool.compute_all()
    for lane, sid in enumerate(ids):
        lane_want = counts(torch.stack([p[lane] for p, _ in steps]), torch.stack([t[lane] for _, t in steps]))
        check(np.array_equal(values[sid].cpu().numpy(), lane_want), f"pool lane {lane} differs from numpy")
    same("pool_lane0", values[ids[0]], counts(torch.stack([p[0] for p, _ in steps]), torch.stack([t[0] for _, t in steps])))
    digests["pool_all"] = hashlib.sha256(b"".join(values[sid].cpu().numpy().tobytes() for sid in ids)).hexdigest()
    pool_lanes = int(lanes_k)
    check(pool_lanes == (1 + sizes["pool_steps"] if on_card else 0),
          f"B1 across lanes {pool_lanes} launches for a warm_start and {sizes['pool_steps']} pool steps")
    del pool, values

    # 3. an SPMD engine of 8 rows of the metric
    engine = MulticlassConfusionMatrix(num_classes=c, device=dev).to_spmd(mesh=build_mesh(devices=[dev] * sizes["rows"]))
    batches = [(draw(batch), draw(batch)) for _ in range(sizes["engine_steps"])]
    engine_out = engine.warm_start(*batches[0])
    for p, t in batches:
        value = engine.step(p, t)
    same("engine_value", value, counts(torch.stack([p for p, _ in batches]), torch.stack([t for _, t in batches])))
    engine_lanes = int(lanes_k) - pool_lanes
    check(engine_lanes == (1 + sizes["engine_steps"] if on_card else 0),
          f"B1 across rows {engine_lanes} launches for a warm_start and {sizes['engine_steps']} engine steps")
    check(not engine.degraded, "the engine degraded")
    del engine
    stats = aot_stats()

    small = _aot_small_launches(torch, np, ce, lh, ka, kb, dev, gen) if on_card else {}
    return {
        "seconds": {
            "import": t_import - t_start, "cuda_init": t_cuda - t_import, "libraries": t_libs - t_cuda,
            "warm_up": (t_pre - t0) - (cap1 - cap0), "capture": cap1 - cap0, "first_replay": t_replay - t_pre,
            "to_first_replay": t_replay - t_start,
        },
        "libraries": {name: {"route": info["route"], "seconds": info["seconds"]} for name, info in infos.items()},
        "library_stats": {k: lib_stats.get(k, 0) for k in ("library_hits", "library_misses", "library_fallbacks",
                                                             "library_builds", "library_writes")},
        "precompile": {k: s1.get(k, 0) - s0.get(k, 0) for k in ("hits", "misses", "fallbacks", "writes")},
        "stats": stats,
        "outcomes": {"pool": pool_out, "engine": engine_out},
        "b1_launches": metric_b1, "lanes_launches": pool_lanes + engine_lanes,
        "digests": digests,
        "small_launches_max_abs_err": small,
        "nvcc_on_path": shutil.which("nvcc") is not None,
    }


def phase_aot_cold_start(torch, np, dev, seed: int, smi: str, sizes=None) -> dict:
    """Phase 57: a fresh replica's cold start with and without the AOT cache, and a damaged cache.

    Three child processes (``aot_child``) share one cache directory, each
    with its own build directory: ``cold`` builds and stores, ``warm`` runs
    with no ``nvcc`` reachable, ``damaged`` meets a flipped byte in the
    ``confmat`` library's artifact and a truncated metric record. Every
    directory made here is removed at the end.
    """
    from torchmetrics_tpu_torch._aot.cache import AotCache

    sizes = {**AOT_SIZES, **(sizes or {})}
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tm_aot_cold_start_")
    here = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "cache")
    children = {}

    def run(mode: str, **env_extra) -> dict:
        env = dict(os.environ, TM_TPU_AOT_CACHE=cache, **env_extra)
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", _AOT_CHILD, here, str(dev), os.path.join(root, f"build_{mode}"),
                               str(seed), json.dumps(sizes)], env=env, capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        check(proc.returncode == 0, f"the {mode} child failed: {proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["seconds"]["startup"] = out.pop("t_start_epoch") - t0
        out["seconds"]["process"] = wall
        children[mode] = out
        return out

    try:
        n_libs = len(AOT_LIBRARIES) if on_card else 0
        cold = run("cold")
        ls = cold["library_stats"]
        check(all(v["route"] == "nvcc" for v in cold["libraries"].values()) and ls["library_builds"] == n_libs
              and ls["library_writes"] == n_libs, f"cold: libraries {cold['libraries']}, {ls}")
        check(cold["precompile"] == {"hits": 0, "misses": 1, "fallbacks": 0, "writes": 1}, f"cold: {cold['precompile']}")
        check(cold["outcomes"] == {"pool": {"stream_step": "compiled", "stream_compute_one": "ready",
                                            "stream_compute_all": "ready"},
                                   "engine": {"spmd_step": "compiled", "spmd_compute": "ready"}}, f"cold: {cold['outcomes']}")
        check(cold["stats"]["writes"] == 3 and cold["stats"]["hits"] == 0, f"cold: {cold['stats']}")

        # a fresh replica with no nvcc anywhere it could look: every library from the cache, every step a hit
        no_cuda_home = os.path.join(root, "empty_cuda_home")
        os.mkdir(no_cuda_home)
        path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                               if d and not os.path.exists(os.path.join(d, "nvcc")))
        warm = run("warm", PATH=path, CUDA_HOME=no_cuda_home)
        ls = warm["library_stats"]
        check(not warm["nvcc_on_path"], "the warm child could reach nvcc")
        check(all(v["route"] == "cache" for v in warm["libraries"].values()) and ls["library_hits"] == n_libs
              and ls["library_builds"] == 0, f"warm: libraries {warm['libraries']}, {ls}")
        check(warm["precompile"] == {"hits": 1, "misses": 0, "fallbacks": 0, "writes": 0}, f"warm: {warm['precompile']}")
        check(warm["outcomes"] == {"pool": {"stream_step": "hit", "stream_compute_one": "ready",
                                            "stream_compute_all": "ready"},
                                   "engine": {"spmd_step": "hit", "spmd_compute": "ready"}}, f"warm: {warm['outcomes']}")
        check(warm["stats"]["hits"] == 3 and warm["stats"]["writes"] == 0 and warm["stats"]["library_builds"] == 0,
              f"warm: {warm['stats']}")

        # damage: one byte of the confmat library's artifact, and the metric's record cut in half
        entries = AotCache(cache).entries()
        records = [e for e in entries if e.get("kind") == "auto_update"]
        check(len(records) == 1, f"{len(records)} auto_update records")
        with open(records[0]["path"], "r+b") as fh:
            fh.truncate(records[0]["file_bytes"] // 2)
        libs = [e for e in entries if e.get("kind") == "kernel_library" and e.get("owner") == "confmat.cu"]
        check(len(libs) == (1 if on_card else 0), f"{len(libs)} confmat library artifacts")
        for e in libs:
            with open(e["path"], "r+b") as fh:
                fh.seek(e["file_bytes"] - 4096)
                byte = fh.read(1)
                fh.seek(e["file_bytes"] - 4096)
                fh.write(bytes([byte[0] ^ 0xFF]))
        damaged = run("damaged")
        ls = damaged["library_stats"]
        routes = {name: v["route"] for name, v in damaged["libraries"].items()}
        want_routes = {name: ("nvcc" if name == "confmat" else "cache") for name in AOT_LIBRARIES} if on_card else {}
        check(routes == want_routes and ls["library_fallbacks"] == (1 if on_card else 0)
              and ls["library_builds"] == (1 if on_card else 0) and ls["library_writes"] == (1 if on_card else 0),
              f"damaged: libraries {routes}, {ls}")
        check(damaged["precompile"] == {"hits": 0, "misses": 0, "fallbacks": 1, "writes": 1},
              f"damaged: {damaged['precompile']}")
        check(damaged["outcomes"] == warm["outcomes"], f"damaged: {damaged['outcomes']}")
        entries = AotCache(cache).entries()
        check(all(e["status"] == "ok" and not e["stale"] for e in entries), "damaged: the cache was not healed")

        check(cold["digests"] == warm["digests"] == damaged["digests"], "the children's states differ")
        artifacts = [{"kind": e["kind"], "owner": e["owner"] if e["kind"] == "kernel_library" else e["owner"].rsplit(".", 1)[-1],
                      "bytes": e["file_bytes"]} for e in entries]
        saved = cold["seconds"]["to_first_replay"] - warm["seconds"]["to_first_replay"]
        nvcc_s = max((v["seconds"] for v in cold["libraries"].values()), default=0.0)
        for mode, out in children.items():
            emit({"phase": "aot_cold_start", "child": mode, "seconds": out["seconds"],
                  "libraries": out["libraries"], "stats": out["stats"], "outcomes": out["outcomes"],
                  "precompile": out["precompile"], "b1_launches": out["b1_launches"],
                  "lanes_launches": out["lanes_launches"],
                  "small_launches_max_abs_err": out["small_launches_max_abs_err"]})
        out = {"phase": "aot_cold_start", "classes": sizes["classes"], "artifacts": artifacts,
               "cache_bytes": sum(a["bytes"] for a in artifacts),
               "to_first_replay_s": {m: o["seconds"]["to_first_replay"] for m, o in children.items()},
               "cold_minus_warm_s": saved, "cold_nvcc_s": nvcc_s,
               "b1_launches": sum(o["b1_launches"] for o in children.values()),
               "lanes_launches": sum(o["lanes_launches"] for o in children.values()),
               "seconds": time.perf_counter() - t_phase, "card": smi}
        emit(out)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ spmd_process_group
# phase 58: the SPMD engine over a mesh that spans a process group (one process a card), on one card: a world-1 NCCL
# group whose collectives the engine captures into each key's CUDA graph, phase 54's main path on 8 rows under it,
# each step bit for bit with the plain 8-row mesh
PG_SIZES = {"rows": 8, "batch": 1024, "gather_steps": 6, "cat_capacity": 8192, "fault_at": 4, "short_steps": 8,
            "snapshot_every": 2, "group_steps": 4, "lpips_pairs": 8, "lpips_side": 256, "lpips_steps": 3,
            "timed_steps": 24}


def _bits(torch, value) -> list:
    """A value's tensors (dict keys sorted) as flat bytes on the host: equal lists are equal bits."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _bits(torch, value[k])]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _bits(torch, v)]
    t = value.detach().contiguous().reshape(-1)
    return [(str(t.dtype), tuple(value.shape), t.view(torch.uint8).cpu().numpy().tobytes())]


def _replay_listing(torch, fn) -> dict:
    """One call of ``fn`` under the profiler: each device row's name and calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {evt.key: evt.count for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0}


def phase_spmd_process_group(torch, np, kernel, lh, dev, gen, logits, target, smi: str, sizes=None) -> dict:
    """Phase 58: the SPMD engine over a mesh that spans a process group, its collectives captured in the step's graph.

    A world-1 process group (NCCL on the card, gloo on the CPU) over a ``HashStore``, made at the start and destroyed
    at the end; a mesh of 8 rows on the card over it (``build_mesh(devices=[dev] * 8, process_group=...)``), held bit
    for bit against the plain 8-row mesh fed the same batches:

    1. Phase 54's main path, BASELINE config 2's in-graph members on the imagenet_val data in global batches of
       1,024, the last of 848: every step bit for bit; B1's lane-batched launches one a step (counted over the
       process-group engine's steps alone); one graph a key, every later step a replay; the collectives each key's
       capture issued (config 2's states are integer sums: one all-reduce a key, no gather).
    2. A leg that captures all-gathers (floating sums, Pearson's gathered moments) and a ``CatMetric`` ring (whose
       compute has a data-dependent length: both meshes degrade and continue eagerly, the eager sync over the group).
    3. One replay of each kind of key under the profiler, beside the plain mesh's, reported: the device work the
       group's collectives left in the graph (at one rank an in-place all-reduce may leave none, and an all-gather a
       copy).
    4. Replica groups, an injected step failure and a snapshot restore, each bit for bit with the plain mesh.
    5. LPIPS alex through the engine, B3 once a tap a step.
    6. ``build_mesh()`` under the group: one row on the current card, world 1.
    7. A mesh on the card over a gloo group: refused at construction.
    8. Host and device ms a step (medians) against the plain mesh, kernels a step and graph memory.
    """
    import torch.distributed as dist

    tp = importlib.import_module("torchmetrics_tpu_torch")
    spmd = importlib.import_module("torchmetrics_tpu_torch._spmd")
    spmd_fi = importlib.import_module("torchmetrics_tpu_torch._spmd.faultinject")
    res = importlib.import_module("torchmetrics_tpu_torch._resilience")
    compile_mod = importlib.import_module("torchmetrics_tpu_torch._compile")
    sizes = dict(PG_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    n_val, c = logits.shape
    rows, batch = sizes["rows"], sizes["batch"]
    batches = [(logits[s:s + batch], target[s:s + batch]) for s in range(0, n_val, batch)]
    check(not dist.is_initialized(), "a process group is already initialized before phase 58")
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            **({"device_id": dev} if on_card else {}))
    try:
        group = dist.group.WORLD
        mesh = spmd.build_mesh(devices=[dev] * rows, process_group=group)
        plain = spmd.build_mesh(devices=[dev] * rows)
        check((mesh.shape["dp"], mesh.local_rows, mesh.processes, mesh.rank) == (rows, rows, 1, 0),
              f"the process-group mesh: {mesh.shape}, {mesh.local_rows} rows, {mesh.processes} processes")
        lanes_k = kernel.confusion_matrix_lanes.launches

        def collection():
            return tp.MetricCollection(spmd_members(tp, c, dev))

        def stream(eng, pairs):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return [_bits(torch, eng.step(*b)) for b in pairs]

        # ------------------------------------------------------------ 1. the main path
        eng = collection().to_spmd(mesh=mesh)
        per_step, host_ms, values = [], [], []
        stats0 = compile_mod.stats()
        lanes_k.reset()  # the main path: counted from here
        for p, t in batches:
            before = int(lanes_k)
            h0 = time.perf_counter()
            values.append(_bits(torch, eng.step(p, t)))
            host_ms.append((time.perf_counter() - h0) * 1e3)
            per_step.append(int(lanes_k) - before)
        if on_card:
            torch.cuda.synchronize()
        lanes_launches = int(lanes_k)  # the main path: read here
        stats1 = compile_mod.stats()
        steps = len(batches)
        ref = collection().to_spmd(mesh=plain)
        want = stream(ref, batches)
        differ = [i for i, (a, b) in enumerate(zip(values, want)) if a != b]
        check(not differ, f"steps {differ[:5]} of the process-group mesh differ from the plain mesh")
        check(lanes_launches == (steps if on_card else 0) and set(per_step) == {1 if on_card else 0},
              f"B1 lane-batched launches {lanes_launches} for {steps} steps ({sorted(set(per_step))} a step)")
        check(not eng.degraded and eng.capture_failures == {}, f"degraded {eng.degraded}, captures {eng.capture_failures}")
        graphs = {"captured": stats1["captured"] - stats0["captured"], "replayed": stats1["replayed"] - stats0["replayed"]}
        if on_card:
            check(all(isinstance(e, compile_mod.CapturedStep) for e in eng._step_fns.values()), "a key is not a CUDA graph")
            check(graphs == {"captured": 2, "replayed": steps - 2}, f"graphs {graphs} for {steps} steps")
        collectives = list(eng.collectives.values())
        check(len(collectives) == 2 and all(k == {"all_reduce": 1} for k in collectives),
              f"config 2's collectives a key: {collectives}")
        preds_all = logits.argmax(-1).cpu().numpy()
        cm_ref = np.bincount(target.cpu().numpy() * c + preds_all, minlength=c * c).reshape(c, c)
        check(np.array_equal(eng.compute()["cm"].cpu().numpy(), cm_ref), "the final confusion matrix != numpy")
        main = {"steps": steps, "batch": batch, "last_batch": int(batches[-1][0].shape[0]), "rows": rows,
                "backend": backend, "lanes_launches": lanes_launches, "graphs": graphs,
                "collectives_per_key": collectives, "bit_for_bit_steps": steps - len(differ),
                "host_ms_median": statistics.median(host_ms),
                "graph_pool_bytes": compile_mod.pool_bytes(eng._graph_pool) if on_card else 0}

        # ------------------------------------------------------------ 2. all-gathers and a ring
        gsteps = batches[:sizes["gather_steps"]]
        pairs = [(p[:, 0].contiguous(), p[:, 1].contiguous()) for p, _ in gsteps]
        gather = {}
        gathered_engines = {}
        for name, make, args in (
            ("MeanSquaredError", lambda: tp.MeanSquaredError(device=dev), pairs),
            ("PearsonCorrCoef", lambda: tp.PearsonCorrCoef(device=dev), pairs),
            ("CatMetric", lambda: tp.CatMetric(device=dev, cat_state_capacity=sizes["cat_capacity"],
                                               nan_strategy="disable"), [(p[:, :4],) for p, _ in gsteps]),
        ):
            g_eng, p_eng = make().to_spmd(mesh=mesh), make().to_spmd(mesh=plain)
            got, ref_vals = stream(g_eng, args), stream(p_eng, args)
            check(got == ref_vals, f"{name}: the process-group mesh != the plain mesh")
            check(g_eng.degraded == (name == "CatMetric") and g_eng.degraded == p_eng.degraded,
                  f"{name}: degraded {g_eng.degraded} (plain {p_eng.degraded})")
            check(g_eng.capture_failures == {}, f"{name}: captures {g_eng.capture_failures}")
            gather[name] = {"steps": len(args), "degraded": g_eng.degraded,
                            "collectives_per_key": list(g_eng.collectives.values()),
                            "captured": sum(isinstance(e, compile_mod.CapturedStep) for e in g_eng._step_fns.values())}
            if not g_eng.degraded:
                check(all(k.get("all_gather", 0) >= 1 for k in gather[name]["collectives_per_key"]),
                      f"{name}: no all-gather in {gather[name]['collectives_per_key']}")
            gathered_engines[name] = (g_eng, p_eng, args[0])

        # ------------------------------------------------------------ 3. what one replay leaves on the card
        # A report, not a check: late in a long process the profiler has returned a replay with only part of its
        # device rows, or none (phase 54's 158-launch step listed 112), so up to three sessions a pair are taken
        # until the group's replay lists more device work than the plain one's. That the captured all-gathers run
        # at every replay is checked above: the gathered states are written only by them, and every step of the
        # gather leg is bit for bit with the plain mesh.
        listing = {}
        if on_card:
            for name, (g_eng, p_eng, args) in (("config2", (eng, ref, batches[0])),
                                              ("MeanSquaredError", gathered_engines["MeanSquaredError"])):
                for attempt in range(1, 4):
                    g_rows = _replay_listing(torch, lambda: g_eng.step(*args))
                    p_rows = _replay_listing(torch, lambda: p_eng.step(*args))
                    if sum(g_rows.values()) > sum(p_rows.values()):
                        break
                extra = {k: v - p_rows.get(k, 0) for k, v in g_rows.items() if v > p_rows.get(k, 0)}
                listing[name] = {"device_ops": sum(g_rows.values()), "plain_device_ops": sum(p_rows.values()),
                                 "sessions": attempt, "extra": {k[:64]: v for k, v in extra.items()}}
        del gathered_engines

        # ------------------------------------------------------------ 4. groups, a failure, a snapshot
        short = batches[:sizes["short_steps"]]
        groups = {"halves": [list(range(rows // 2)), list(range(rows // 2, rows))],
                  "interleaved": [list(range(0, rows, 2)), list(range(1, rows, 2))]}
        group_line = {}
        for layout, gs in groups.items():
            g_vals = stream(collection().to_spmd(mesh=mesh, groups=gs), batches[:sizes["group_steps"]])
            p_vals = stream(collection().to_spmd(mesh=plain, groups=gs), batches[:sizes["group_steps"]])
            check(g_vals == p_vals, f"replica groups {layout}: the process-group mesh != the plain mesh")
            group_line[layout] = {"groups": gs, "steps": sizes["group_steps"], "bit_for_bit": True}

        def faulted(m):
            out = []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for i, (p, t) in enumerate(short):
                    if i == sizes["fault_at"]:
                        with spmd_fi.inject_step_failure(times=1):
                            out.append(_bits(torch, m.step(p, t)))
                    else:
                        out.append(_bits(torch, m.step(p, t)))
            return out

        f_eng = collection().to_spmd(mesh=mesh)
        f_vals, f_ref = faulted(f_eng), faulted(collection().to_spmd(mesh=plain))
        check(f_eng.degraded and f_vals == f_ref, "the injected failure: fold and eager continuation != the plain mesh's")
        events = [e.detail for m in f_eng.target.values() for e in m.resilience_report().events
                  if e.kind == "spmd_degraded"]
        check(len(events) == 1 and "folded its own rows" in events[0], f"degradation events {events}")
        fault_line = {"at_step": sizes["fault_at"], "steps": len(short), "bit_for_bit": True, "event": events[0][:200]}

        with tempfile.TemporaryDirectory() as folder:
            live = collection().to_spmd(mesh=mesh)
            mgr = res.SnapshotManager(live, folder, res.SnapshotPolicy(every_n_updates=sizes["snapshot_every"],
                                                                      async_write=False))
            cut = len(short) // 2 + 1
            stream(live, short[:cut])
            mgr.close()  # the process is preempted here
            restored = collection().to_spmd(mesh=mesh)
            mgr2 = res.SnapshotManager(restored, folder, res.SnapshotPolicy(async_write=False))
            report = mgr2.restore_latest()
            mgr2.close()
            resume = restored.steps
            after = stream(restored, short[resume:])
            check(0 < resume <= cut and after == want[resume:len(short)] and not restored.degraded,
                  f"restore at {resume} and stream to {len(short)} != the plain mesh")
            flat = collection().to_spmd(mesh=spmd.build_mesh(devices=[dev] * (rows // 2)))
            try:
                flat.load_state_dict(live.state_dict())
                refusal = None
            except Exception as err:  # noqa: BLE001 - the refusal is the check
                refusal = str(err)
            check(refusal is not None and "identical mesh layout" in refusal, f"a 1 x 4 engine took a 1 x 8 snapshot")
            snapshot_line = {"preempted_at": cut, "restored_at": resume, "generation": report.generation,
                             "bit_for_bit": True, "other_layout_refused": refusal[:160]}
            del live, restored, flat

        # ------------------------------------------------------------ 5. LPIPS alex
        lp, ls = sizes["lpips_pairs"], sizes["lpips_side"]
        img0 = torch.rand((sizes["lpips_steps"], rows * lp, 3, ls, ls), generator=gen, device=dev) * 2 - 1
        img1 = (img0 + 0.3 * torch.randn(img0.shape, generator=gen, device=dev)).clamp_(-1, 1)
        lp_eng = tp.LearnedPerceptualImagePatchSimilarity(net_type="alex", device=dev).to_spmd(mesh=mesh)
        b3 = lh.lpips_head.launches
        b3.reset()  # this part's main path: counted from here
        lp_vals = stream(lp_eng, [(img0[k], img1[k]) for k in range(sizes["lpips_steps"])])
        if on_card:
            torch.cuda.synchronize()
        b3_launches = int(b3)  # read here
        lp_plain = tp.LearnedPerceptualImagePatchSimilarity(net_type="alex", device=dev).to_spmd(mesh=plain)
        lp_want = stream(lp_plain, [(img0[k], img1[k]) for k in range(sizes["lpips_steps"])])
        check(b3_launches == (5 * sizes["lpips_steps"] if on_card else 0), f"B3 launches {b3_launches}")
        check(lp_vals == lp_want and not lp_eng.degraded and lp_eng.capture_failures == {},
              f"LPIPS: process-group mesh vs plain mesh equal {lp_vals == lp_want}, degraded {lp_eng.degraded}")
        lpips_line = {"rows": rows, "pairs_per_row": lp, "side": ls, "steps": sizes["lpips_steps"],
                      "b3_launches": b3_launches, "bit_for_bit": True,
                      "collectives_per_key": list(lp_eng.collectives.values()),
                      "graph_pool_bytes": compile_mod.pool_bytes(lp_eng._graph_pool) if on_card else 0}

        # ------------------------------------------------------------ 6. the default mesh under the group
        default = spmd.build_mesh()
        default_line = {"world": default.shape["dp"], "rows": default.local_rows, "device": str(default.devices[0])}
        check(default_line == {"world": 1, "rows": 1, "device": str(dev)}, f"build_mesh() under the group: {default_line}")
        d_eng = collection().to_spmd()
        d_vals, d_ref = stream(d_eng, batches[:2]), stream(collection().to_spmd(mesh=spmd.build_mesh(devices=[dev])),
                                                           batches[:2])
        check(d_vals == d_ref and d_eng.process_group is group, "to_spmd() under the group != a plain mesh of one row")
        del d_eng

        # ------------------------------------------------------------ 7. a card's mesh over a gloo group
        gloo = dist.new_group(backend="gloo")
        try:
            tp.MetricCollection(spmd_members(tp, c, dev)).to_spmd(
                mesh=spmd.build_mesh(devices=["cuda:0"] * rows, process_group=gloo))
            gloo_refused = None
        except spmd.InGraphSyncUnsupported as err:
            gloo_refused = str(err)[:160]
        check(gloo_refused is not None and "NCCL group" in gloo_refused, "a mesh on the card over gloo was let through")

        # ------------------------------------------------------------ 8. timings
        timing = {}
        if on_card:
            p, t = batches[0]

            def host_device(fn, reps):
                hosts, events = [], []
                for _ in range(reps):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    h0 = time.perf_counter()
                    start.record()
                    fn()
                    end.record()
                    hosts.append((time.perf_counter() - h0) * 1e3)
                    events.append((start, end))
                torch.cuda.synchronize()
                return {"host_ms": statistics.median(hosts),
                        "device_ms": statistics.median(s.elapsed_time(e) for s, e in events)}

            # alternated, so that both see the same clocks
            for label, e in (("plain_step", ref), ("group_step", eng), ("plain_step_again", ref),
                             ("group_step_again", eng)):
                timing[label] = host_device(lambda: e.step(p, t), sizes["timed_steps"])
            timing["group_kernels"] = device_time_by_kernel(torch, lambda: eng.step(p, t), top=8)
            timing["plain_kernels"] = device_time_by_kernel(torch, lambda: ref.step(p, t), top=8)
            timing["lpips_group_step"] = host_device(lambda: lp_eng.step(img0[0], img1[0]), 8)
            timing["lpips_plain_step"] = host_device(lambda: lp_plain.step(img0[0], img1[0]), 8)
        del eng, ref, lp_eng, lp_plain
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the phase left a process group behind")
    release_graphs(torch)
    out = {
        "phase": "spmd_process_group", "samples": n_val, "classes": c, "processes": 1, "backend": backend,
        "main": main, "gather": gather, "replay_listing": listing, "replica_groups": group_line,
        "injected_failure": fault_line, "snapshot_restore": snapshot_line, "lpips_alex": lpips_line,
        "default_mesh": default_line, "gloo_on_card_refused": gloo_refused, "timing": timing,
        "tolerance": "bit for bit with the plain 8-row mesh", "seconds": time.perf_counter() - t_phase, "card": smi,
    }
    emit(out)
    return out


ANALYSIS_SIZES = {"classes": 1000, "batches": (1024, 1000, 968, 936, 904, 872), "tenants": 256, "capacity": 256,
                  "queue_capacity": 1024, "max_batch": 64, "rows": 1024, "requests": 384, "clients": 4,
                  "fleet_branching": (2, 2), "fleet_epochs": 2, "fleet_updates": 2, "pool_capacity": 8, "lanes": 8,
                  "mesh_rows": 8, "mesh_batch": 1024, "mesh_steps": 6}


def phase_analysis(torch, np, kernel, dev, gen, logits, target, smi: str, sizes=None) -> dict:
    """Phase 59: the port's static analysis at work on the card: the R1 certificate in ``Metric``, and sanitized runs.

    (a) BASELINE config 2's collection (phase 54's members, 1,000 classes) takes the imagenet_val logits in six
        batches of different sizes, so every member update is a signature's first sighting and runs eagerly under
        the fingerprint guard: once with the certificate's skip on (``set_fingerprint_skip_enabled(True)``), once
        off. The states must be bit for bit between the two runs; ``fingerprint|outcome=skip`` in the first run and
        ``check`` in the second must each equal the eager updates of the certified members; B1's launches must
        equal the eager updates of the members that count a matrix, in each run. Reports the host ms of an eager
        collection update (median) in both runs.
    (b) ``set_locksan_enabled(True)`` before the objects are built, then: a metric server at phase 55's shapes
        taking 384 requests from 4 client threads, every tenant bit for bit with numpy; a fleet ``(2, 2)`` rollup
        of 2 epochs, the root bit for bit with numpy; a concurrent ``warm_start`` of one pool key from two threads
        with the AOT cache set (its reentrant resolution lock serializes the build; the pool's units are prepared
        by a serial ``warm_start`` first, as in the JAX suite's race), which builds it once; a step stream of the mesh over a world-1 process group (NCCL on the card), bit for
        bit with the plain mesh. Each run must end with ``locksan.violations() == []``, and reports its B1
        launches (lane-batched and plain). A ``LockDisciplineError`` is not caught: it fails the phase.
    """
    import threading

    import torch.distributed as dist

    tp = importlib.import_module("torchmetrics_tpu_torch")
    obs = importlib.import_module("torchmetrics_tpu_torch._observability")
    cert = importlib.import_module("torchmetrics_tpu_torch._analysis.manifest")
    locksan = importlib.import_module("torchmetrics_tpu_torch._analysis.locksan")
    serving = importlib.import_module("torchmetrics_tpu_torch._serving")
    fleet = importlib.import_module("torchmetrics_tpu_torch._fleet")
    spmd = importlib.import_module("torchmetrics_tpu_torch._spmd")
    compiled = importlib.import_module("torchmetrics_tpu_torch._compile")
    sizes = dict(ANALYSIS_SIZES, **(sizes or {}))
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    c, rows = sizes["classes"], sizes["rows"]
    b1, lanes_k = kernel.confusion_matrix_cuda.launches, kernel.confusion_matrix_lanes.launches
    out = {"phase": "analysis", "device": smi}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ------------------------------------------------ (a) the certificate in the eager update
    bounds = np.cumsum((0,) + tuple(sizes["batches"]))
    batches = [(logits[a:b], target[a:b]) for a, b in zip(bounds, bounds[1:])]
    certified = sorted(k for k, m in spmd_members(tp, c, dev).items() if cert.fingerprint_skip_allowed(type(m)))
    matrix_members = ("cm", "mcc", "jaccard")  # the members whose update counts a (C, C) matrix (B1 from 256 classes)
    check("cm" in certified, f"certified members of config 2: {certified}")
    was_on = obs.telemetry_enabled()
    obs.set_telemetry_enabled(True)
    runs = {}
    try:
        for skip in (True, False):
            cert.set_fingerprint_skip_enabled(skip)
            obs.REGISTRY.reset()
            mc = tp.MetricCollection(spmd_members(tp, c, dev))
            sync()
            b1.reset()
            host_ms = []
            for p, t in batches:
                h0 = time.perf_counter()
                mc.update(p, t)
                host_ms.append((time.perf_counter() - h0) * 1e3)
            sync()
            reps = {k: m.telemetry_report() for k, m in mc.items(copy_state=False)}
            eager = {k: r.path_counts.get("eager", 0) for k, r in reps.items()}
            runs[skip] = {
                "eager_updates": eager,
                "fingerprint": {o: sum(r.counter(f"fingerprint|outcome={o}") for r in reps.values())
                                for o in ("skip", "check", "ineligible")},
                "b1_launches": int(b1),
                "host_ms_median": statistics.median(host_ms),
                "host_ms": host_ms,
                "states": {k: _bits(torch, [getattr(m, n) for n in sorted(m._defaults)])
                           for k, m in mc.items(copy_state=False)},
            }
            del mc
    finally:
        cert.set_fingerprint_skip_enabled(True)
        obs.set_telemetry_enabled(was_on)
    on, off = runs[True], runs[False]
    check(on["states"] == off["states"], "the states differ with and without the fingerprint skip")
    check(on["eager_updates"] == off["eager_updates"], f"eager updates {on['eager_updates']} / {off['eager_updates']}")
    certified_eager = sum(n for k, n in on["eager_updates"].items() if k in certified)
    check(certified_eager > 0, f"no eager update of a certified member: {on['eager_updates']}")
    check(on["fingerprint"]["skip"] == certified_eager and off["fingerprint"]["check"] == on["fingerprint"]["check"]
          + certified_eager and off["fingerprint"]["skip"] == 0,
          f"fingerprint outcomes {on['fingerprint']} (skip on) / {off['fingerprint']} (skip off), "
          f"{certified_eager} eager updates of certified members")
    matrix_eager = sum(on["eager_updates"].get(k, 0) for k in matrix_members)
    for run in (on, off):
        check(run["b1_launches"] == (matrix_eager if on_card else 0), f"B1 launches {run['b1_launches']} for "
              f"{matrix_eager} eager updates of the matrix members")
    out["certificate"] = {
        "batches": list(sizes["batches"]), "certified_members": certified, "eager_updates": on["eager_updates"],
        "fingerprint_skip_on": on["fingerprint"], "fingerprint_skip_off": off["fingerprint"],
        "b1_launches_per_run": on["b1_launches"], "host_ms_median_skip_on": on["host_ms_median"],
        "host_ms_median_skip_off": off["host_ms_median"], "host_ms_skip_on": on["host_ms"],
        "host_ms_skip_off": off["host_ms"],
    }
    b1_total = on["b1_launches"] + off["b1_launches"]
    lanes_total = 0
    del runs, on, off

    # ------------------------------------------------ (b) the sanitized runs
    def template():
        return tp.classification.MulticlassConfusionMatrix(num_classes=c, ignore_index=-1, device=dev)

    locksan.set_locksan_enabled(True)
    locksan.reset()
    try:
        # 1. a metric server at phase 55's shapes
        n_ten, n_req = sizes["tenants"], sizes["requests"]
        req_p = torch.randint(0, c, (n_req, rows), generator=gen, device=dev).cpu().numpy()
        req_t = torch.randint(0, c, (n_req, rows), generator=gen, device=dev).cpu().numpy()
        server = serving.MetricServer(template(), capacity=sizes["capacity"], queue_capacity=sizes["queue_capacity"],
                                      controller=serving.ControllerConfig(max_batch=sizes["max_batch"]))
        check(isinstance(server._pool_lock, locksan.SanLock) and isinstance(server.queue._lock, locksan.SanLock),
              "the sanitized server took plain locks")
        sids = [server.attach_stream() for _ in range(n_ten)]
        sync()
        lanes_k.reset()
        b1.reset()
        h0 = time.perf_counter()
        server.warm(req_p[0], req_t[0])
        rows_of = {sid: [] for sid in sids}
        acks, retries = [], []
        deadline = time.monotonic() + 120.0
        server.start()

        failures = []

        def client(k):
            try:
                for r in range(k, n_req, sizes["clients"]):
                    sid = sids[r % n_ten]
                    ack = _submit_until_admitted(serving, server, sid, req_p[r], req_t[r], retries, deadline)
                    check(ack is not None, f"request {r} was never admitted")
                    acks.append(ack)
                    rows_of[sid].append((req_p[r], req_t[r]))
                    outcome = ack.result(timeout=60.0)
                    check(outcome == "acked", f"request {r}: {outcome}")
            except BaseException as err:  # noqa: BLE001 - re-raised on the phase's thread below
                failures.append(err)

        clients = [threading.Thread(target=client, args=(k,), name=f"analysis-client-{k}")
                   for k in range(sizes["clients"])]
        for th in clients:
            th.start()
        for th in clients:
            th.join()
        server.stop(drain=True)
        if failures:
            raise failures[0]
        sync()
        served_s = time.perf_counter() - h0
        check(len(acks) == n_req and all(a.result(timeout=0.0) == "acked" for a in acks), "an ack is not acked")
        bad, _ = _served_equal(np, server, rows_of, c)
        check(not bad, f"tenants {bad[:5]} differ from numpy")
        server.close()
        check(locksan.violations() == [], f"server: {locksan.violations()[:3]}")
        out["server"] = {"requests": n_req, "tenants": n_ten, "clients": sizes["clients"], "seconds": served_s,
                         "batches": server.batches, "retries": len(retries), "lanes_launches": int(lanes_k),
                         "b1_launches": int(b1), "violations": 0}
        lanes_total += int(lanes_k)
        b1_total += int(b1)
        del server
        release_graphs(torch)

        # 2. a fleet (2, 2) rollup
        b1.reset()
        h0 = time.perf_counter()
        tree = fleet.FleetTree.build(template(), branching=sizes["fleet_branching"])
        epochs, updates = sizes["fleet_epochs"], sizes["fleet_updates"]
        leaves = tree.leaves
        fp = torch.randint(0, c, (epochs, len(leaves), updates, rows), generator=gen, device=dev)
        ft = torch.randint(0, c, (epochs, len(leaves), updates, rows), generator=gen, device=dev)
        for e in range(epochs):
            for i, leaf in enumerate(leaves):
                for u in range(updates):
                    leaf.update(fp[e, i, u], ft[e, i, u])
            check(not tree.run_epoch(e).partial, f"fleet epoch {e} rolled up partial")
        tree.join_pending(timeout=30.0)
        sync()
        want = _bincount_cm(np, list(fp.cpu().numpy().reshape(-1, rows)), list(ft.cpu().numpy().reshape(-1, rows)), c)
        check(np.array_equal(tree.root.metric.confmat.cpu().numpy(), want), "the sanitized fleet root != numpy")
        check(int(b1) == (epochs * len(leaves) * updates if on_card else 0), f"fleet B1 launches {int(b1)}")
        check(locksan.violations() == [], f"fleet: {locksan.violations()[:3]}")
        out["fleet"] = {"branching": list(sizes["fleet_branching"]), "epochs": epochs, "seconds": time.perf_counter() - h0,
                        "b1_launches": int(b1), "lanes_launches": 0, "violations": 0}
        b1_total += int(b1)
        del tree, fp, ft
        release_graphs(torch)

        # 3. one pool key warmed from two threads at once: built once, under the AOT cache's resolution lock
        lanes = sizes["lanes"]
        aot_dir = tempfile.mkdtemp(prefix="tm_analysis_aot_")
        tp.set_aot_cache(aot_dir)
        pool = template().to_stream_pool(capacity=sizes["pool_capacity"])
        ids = np.array([pool.attach() for _ in range(lanes)])
        wp = torch.randint(0, c, (lanes, rows), generator=gen, device=dev)
        wt = torch.randint(0, c, (lanes, rows), generator=gen, device=dev)
        pool.warm_start(ids[:lanes // 2], wp[:lanes // 2], wt[:lanes // 2])  # the pool's units, prepared serially
        sync()
        lanes_k.reset()
        stats_0 = compiled.stats()
        outcomes, errors = [], []

        def warm():
            try:
                outcomes.append(pool.warm_start(ids, wp, wt)["stream_step"])
            except BaseException as err:  # noqa: BLE001 - reported by the check below, never swallowed
                errors.append(err)

        warmers = [threading.Thread(target=warm, name=f"analysis-warm-{k}") for k in range(2)]
        for th in warmers:
            th.start()
        for th in warmers:
            th.join()
        tp.set_aot_cache(None)
        shutil.rmtree(aot_dir, ignore_errors=True)
        if errors:
            raise errors[0]
        captured = compiled.stats()["captured"] - stats_0["captured"]
        check(sorted(outcomes) == ["compiled", "ready"], f"concurrent warm_start outcomes {outcomes}")
        check(captured == (1 if on_card else 0), f"{captured} captures for one key warmed twice")
        pool.update(ids, wp, wt)
        values = pool.compute_all()
        hp, ht = wp.cpu().numpy(), wt.cpu().numpy()
        check(all(np.array_equal(values[int(sid)].cpu().numpy(), _bincount_cm(np, [hp[i]], [ht[i]], c))
                  for i, sid in enumerate(ids)), "a warmed pool's stream != numpy")
        check(locksan.violations() == [], f"warm_start: {locksan.violations()[:3]}")
        out["warm_start"] = {"threads": 2, "outcomes": sorted(outcomes), "captures": captured,
                             "lanes_launches": int(lanes_k), "b1_launches": 0, "violations": 0}
        lanes_total += int(lanes_k)
        del pool
        release_graphs(torch)

        # 4. the mesh over a world-1 process group
        check(not dist.is_initialized(), "a process group is already initialized before phase 59")
        dist.init_process_group("nccl" if on_card else "gloo", store=dist.HashStore(), rank=0, world_size=1,
                                **({"device_id": dev} if on_card else {}))
        try:
            mesh_rows, mb = sizes["mesh_rows"], sizes["mesh_batch"]
            steps = [(logits[s:s + mb], target[s:s + mb]) for s in range(0, sizes["mesh_steps"] * mb, mb)]
            mesh = spmd.build_mesh(devices=[dev] * mesh_rows, process_group=dist.group.WORLD)
            plain = spmd.build_mesh(devices=[dev] * mesh_rows)
            eng = tp.MetricCollection(spmd_members(tp, c, dev)).to_spmd(mesh=mesh)
            sync()
            lanes_k.reset()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = [_bits(torch, eng.step(p, t)) for p, t in steps]
                sync()
                mesh_lanes = int(lanes_k)
                ref = tp.MetricCollection(spmd_members(tp, c, dev)).to_spmd(mesh=plain)
                want_steps = [_bits(torch, ref.step(p, t)) for p, t in steps]
            check(got == want_steps, "the sanitized process-group mesh != the plain mesh")
            check(mesh_lanes == (len(steps) if on_card else 0), f"mesh B1 lane-batched launches {mesh_lanes}")
            check(not eng.degraded, "the sanitized mesh degraded")
            del eng, ref
        finally:
            dist.destroy_process_group()
        check(locksan.violations() == [], f"mesh: {locksan.violations()[:3]}")
        out["mesh"] = {"rows": mesh_rows, "steps": len(steps), "backend": "nccl" if on_card else "gloo",
                       "lanes_launches": mesh_lanes, "b1_launches": 0, "violations": 0}
        lanes_total += mesh_lanes
    finally:
        locksan.set_locksan_enabled(False)
    release_graphs(torch)
    out["b1_launches"], out["lanes_launches"] = b1_total, lanes_total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main() -> int:
    t_main = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phase", choices=("all", "compiled_path", "compiled_stream", "captured_trunks", "observability",
                                            "resilience", "stream_pool", "trunk_pools", "spmd_collection",
                                            "metric_server", "fleet_rollup", "aot_cold_start", "spmd_process_group",
                                            "analysis"),
                        default="all",
                        help="compiled_path: build, run only the compiled_path phase on the imagenet_val data, stop; "
                             "compiled_stream: build, stream the imagenet_val data in the --order given, stop; "
                             "captured_trunks: build, run only the captured_trunks phase, stop; "
                             "observability: build, run only the observability phase on the imagenet_val data, stop; "
                             "resilience: build, run only the resilience phase on the imagenet_val data, stop; "
                             "stream_pool: build, run only the stream_pool phase, stop; "
                             "trunk_pools: build, run only the trunk_pools phase, stop; "
                             "spmd_collection: build, run only the spmd_collection phase on the imagenet_val data, "
                             "stop; metric_server: build, run only the metric_server phase, stop; "
                             "fleet_rollup: build, run only the fleet_rollup phase, stop; "
                             "aot_cold_start: build, run only the aot_cold_start phase, stop; "
                             "spmd_process_group: build, run only the spmd_process_group phase on the imagenet_val "
                             "data, stop; analysis: build, run only the analysis phase (59) on the imagenet_val data, "
                             "stop")
    parser.add_argument("--order", default="compiled,eager,compiled",
                        help="--phase compiled_stream: comma-separated eager, compiled or traced streams")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix
    from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as kernel
    from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confusion_matrix_format
    from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor
    from torchmetrics_tpu_torch.utilities import nvcc

    # the kernel modules by path: `_kernels` exports a function named like its module
    ce = importlib.import_module("torchmetrics_tpu_torch._kernels.conv_epilogue")
    lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")
    ka = importlib.import_module("torchmetrics_tpu_torch._kernels.attention")
    kb = importlib.import_module("torchmetrics_tpu_torch._kernels.biquad")
    confmat_cuda, confmat_plain = kernel.confusion_matrix_cuda, kernel.confusion_matrix_plain
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 matrix products stay in full float32
    device_name = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------------ build
    t0 = time.perf_counter()
    libraries = {
        "confmat": (kernel.SOURCE, kernel._library),
        "conv_epilogue": (ce.SOURCE, ce._library),
        "lpips_head": (lh.SOURCE, lh._library),
        "attention": (ka.ATTENTION_SOURCE, ka._attention_library),
        "layernorm_residual": (ka.LAYERNORM_SOURCE, ka._layernorm_library),
        "biquad": (kb.SOURCE, kb._library),
    }
    infos = dict(zip(libraries, nvcc.build_all([source for source, _ in libraries.values()])))  # one nvcc each, at once
    for _, load in libraries.values():
        load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # the kernels redesigned for Hopper: registers and spills from ptxas, dynamic shared memory from the library
    redesigned = ptxas_templates(infos["conv_epilogue"]["log"], "mm_bias_relu_tma")
    for key, value in redesigned.items():
        value["smem_bytes"] = ce._library().tm_mm_bias_relu_tma_smem(int(key.split("<")[1][:-1]))
    for template in ("attention_tf32x3", "attention_bf16"):
        for key, value in ptxas_templates(infos["attention"]["log"], template).items():
            value["smem_bytes"] = ka._attention_library().tm_attention_smem(int("bf16" in key), int(key.split("<")[1][:-1]))
            redesigned[key] = value
    # B1 and B3: the instantiations the main paths run, int64 labels under a mask and bf16 maps in
    # 16-byte vectors (1-3 a lane); their dynamic shared memory is 4 * C bytes
    main_path = {"confmat_kernel<i64,1>", *(f"lpips_head_kernel<bf16,8,{k}>" for k in (1, 2, 3))}
    for lib_name, template in (("confmat", "confmat_kernel"), ("lpips_head", "lpips_head_kernel")):
        redesigned.update({k: v for k, v in ptxas_templates(infos[lib_name]["log"], template).items() if k in main_path})
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {
            name: {"nvcc_seconds": round(info["seconds"], 3), "built": info["built"], **ptxas_summary(info["log"])}
            for name, info in infos.items()
        },
        "redesigned_kernels": {k: [v.get("registers"), v.get("spill_bytes"), v.get("smem_bytes", v.get("static_smem_bytes"))]
                               for k, v in redesigned.items()},
        "redesigned_fields": ["registers", "spill_bytes", "smem_bytes (confmat_kernel, lpips_head_kernel: static, "
                              "plus 4 * C dynamic: diagonal counters; head weights)"],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device_name,
    })
    print(smi, flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.phase == "captured_trunks":
        with tempfile.TemporaryDirectory() as folder:
            phase_captured_trunks(torch, np, ce, lh, ka, kb, dev, torch.Generator(device=dev).manual_seed(args.seed + 49),
                                  args.seed, smi, folder)
        print(smi, flush=True)
        return 0
    if args.phase == "observability":
        logits, target = imagenet_val_data(torch, dev, gen)
        with tempfile.TemporaryDirectory() as folder:
            phase_observability(torch, np, kernel, ce, dev, torch.Generator(device=dev).manual_seed(args.seed + 50),
                                logits, target, folder, args.seed, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "resilience":
        logits, target = imagenet_val_data(torch, dev, gen)
        phase_resilience(torch, np, kernel, dev, logits, target, args.seed, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "stream_pool":
        phase_stream_pool(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 52), smi)
        print(smi, flush=True)
        return 0
    if args.phase == "trunk_pools":
        with tempfile.TemporaryDirectory() as folder:
            phase_trunk_pools(torch, np, ce, lh, ka, kb, dev, torch.Generator(device=dev).manual_seed(args.seed + 53),
                              args.seed, smi, folder)
        print(smi, flush=True)
        return 0
    if args.phase == "spmd_collection":
        logits, target = imagenet_val_data(torch, dev, gen)
        phase_spmd_collection(torch, np, kernel, lh, dev, torch.Generator(device=dev).manual_seed(args.seed + 54),
                              logits, target, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "metric_server":
        phase_metric_server(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 55), smi)
        print(smi, flush=True)
        return 0
    if args.phase == "fleet_rollup":
        phase_fleet_rollup(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 56), smi)
        print(smi, flush=True)
        return 0
    if args.phase == "aot_cold_start":
        phase_aot_cold_start(torch, np, dev, args.seed + 57, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "spmd_process_group":
        logits, target = imagenet_val_data(torch, dev, gen)
        phase_spmd_process_group(torch, np, kernel, lh, dev, torch.Generator(device=dev).manual_seed(args.seed + 58),
                                 logits, target, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "analysis":
        logits, target = imagenet_val_data(torch, dev, gen)
        phase_analysis(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 59), logits, target,
                       smi)
        print(smi, flush=True)
        return 0
    if args.phase != "all":
        logits, target = imagenet_val_data(torch, dev, gen)
        if args.phase == "compiled_path":
            phase_compiled_path(torch, np, kernel, dev, gen, logits, target, smi)
        else:
            phase_compiled_stream(torch, kernel, dev, logits, target, args.order.split(","), smi)
        print(smi, flush=True)
        return 0

    # -------------------------------------------------------- kernel_vs_plain
    cases = [
        # (n, C, label dtype, weights, labels)
        (8, 256, torch.int32, None, "uniform"),
        (517, 300, torch.int64, "mask", "uniform"),
        (1024, 1000, torch.int64, "mask", "uniform"),
        (1024, 1000, torch.int32, None, "uniform"),
        (1001, 1001, torch.int32, "float", "uniform"),
        (4_194_304, 847, torch.int64, "mask", "uniform"),
        (4_194_304, 847, torch.int32, "float", "uniform"),
        (1_000_000, 1000, torch.int64, None, "diagonal"),
        (1_000_000, 1000, torch.int32, "float", "diagonal"),
        (100_000, 300, torch.int64, None, "out_of_range"),
        (100_000, 300, torch.int32, "mask", "out_of_range"),
        (100_000, 300, torch.int64, "float", "out_of_range"),
        # views 3 and 1 rows into their arrays: the kernel's scalar head before its 16-byte loads
        (100_003, 300, torch.int64, "mask", "offset_3"),
        (100_001, 300, torch.int32, "float", "offset_1"),
    ]
    max_abs_err = 0.0
    for n, c, dtype, wkind, labels in cases:
        lo, hi = (-2, c + 2) if labels == "out_of_range" else (0, c)
        skip = int(labels.split("_")[1]) if labels.startswith("offset") else 0
        t = torch.randint(lo, hi, (n + skip,), generator=gen, device=dev, dtype=dtype)[skip:]
        p = t.clone() if labels == "diagonal" else torch.randint(lo, hi, (n + skip,), generator=gen, device=dev, dtype=dtype)[skip:]
        w = None
        if wkind == "mask":
            w = (torch.rand(n + skip, generator=gen, device=dev) < 0.9)[skip:]
        elif wkind == "float":
            w = torch.rand(n + skip, generator=gen, device=dev)[skip:]
        got = confmat_cuda(p, t, c, w)
        ref = confmat_plain(p, t, c, w)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype and got.shape == (c, c), f"dtype/shape {got.dtype} {ref.dtype} {got.shape}")
        err = float((got.double() - ref.double()).abs().max())
        in_range = (t >= 0) & (t < c) & (p >= 0) & (p < c)
        if wkind == "float":
            ok = torch.allclose(got, ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
            expected_total = float((w.double() * in_range).sum())
            total_ok = abs(float(got.double().sum()) - expected_total) <= 1e-5 * expected_total + 1e-3
        else:
            ok = torch.equal(got, ref)
            expected = in_range if w is None else in_range & w
            total_ok = int(got.sum()) == int(expected.sum())
        case = f"({n},{c}) {str(dtype).split('.')[-1]} {wkind or 'none'} {labels}"
        check(ok, f"kernel != plain at {case}: max abs err {err}")
        check(total_ok, f"kernel total != count of valid in-range rows at {case}")
        max_abs_err = max(max_abs_err, err)
    emit({
        "phase": "kernel_vs_plain", "cases": len(cases), "max_abs_err": max_abs_err,
        "tolerance": {"counts": "exact", "float32_weights": {"rtol": FLOAT_RTOL, "atol": FLOAT_ATOL}},
    })

    # ----------------------------------------------------------- imagenet_val
    n_val, c_in, batch = 50_000, 1000, 1024
    logits, target = imagenet_val_data(torch, dev, gen, n_val, c_in)
    metrics = [
        MulticlassAccuracy(num_classes=c_in, average="micro"),
        MulticlassAccuracy(num_classes=c_in, average="micro", top_k=5),
        MulticlassConfusionMatrix(num_classes=c_in),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    confmat_cuda.launches.reset()
    t0 = time.perf_counter()
    first_batch_vals = None
    n_batches = 0
    for b, start in enumerate(range(0, n_val, batch)):
        p, t = logits[start:start + batch], target[start:start + batch]
        if b % 2 == 0:
            vals = [m(p, t) for m in metrics]
            first_batch_vals = first_batch_vals or vals
        else:
            for m in metrics:
                m.update(p, t)
        n_batches += 1
    top1, top5, cm = (m.compute() for m in metrics)
    torch.cuda.synchronize()
    imagenet_s = time.perf_counter() - t0
    imagenet_launches = int(confmat_cuda.launches)

    host_logits, host_target = logits.cpu().numpy(), target.cpu().numpy()
    pred1 = host_logits.argmax(axis=1)
    in_top5 = (np.argpartition(-host_logits, 4, axis=1)[:, :5] == host_target[:, None]).any(axis=1)
    ref_cm = np.bincount(host_target * c_in + pred1, minlength=c_in * c_in).reshape(c_in, c_in)
    ref_top1 = np.float32((pred1 == host_target).sum()) / np.float32(n_val)
    ref_top5 = np.float32(in_top5.sum()) / np.float32(n_val)
    ref_b0 = np.float32((pred1[:batch] == host_target[:batch]).sum()) / np.float32(batch)
    check(float(top1) == float(ref_top1), f"top-1 {float(top1)} != host {float(ref_top1)}")
    check(float(top5) == float(ref_top5), f"top-5 {float(top5)} != host {float(ref_top5)}")
    check(float(first_batch_vals[0]) == float(ref_b0), "forward's batch top-1 != host")
    check(np.array_equal(cm.cpu().numpy(), ref_cm), "confusion matrix != host bincount")
    check(imagenet_launches == metrics[2].update_count == n_batches,
          f"confmat launches {imagenet_launches}, updates {metrics[2].update_count}, batches {n_batches}")
    emit({
        "phase": "imagenet_val", "samples": n_val, "classes": c_in, "batches": n_batches,
        "top1": float(top1), "top5": float(top5), "confmat_launches": imagenet_launches,
        "seconds": imagenet_s, "batches_per_s": n_batches / imagenet_s, "samples_per_s": n_val / imagenet_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })

    # ----------------------- confmat_exact_2p24, classification_collection, aggregation
    exact_launches = phase_confmat_exact_2p24(torch, kernel, dev)
    collection = phase_classification_collection(torch, np, kernel, dev, gen, smi)
    phase_aggregation(torch, np, dev, gen)

    # ------------------------------------------------------------ ade20k_full
    c_ade, maps, side, n_updates = 847, 16, 512, 8
    shape = (n_updates, maps, side, side)
    seg_target = torch.randint(0, c_ade, shape, generator=gen, device=dev)
    void = torch.rand(shape, generator=gen, device=dev) < 0.10
    seg_target[void] = -1
    correct = (torch.rand(shape, generator=gen, device=dev) < 0.70) & ~void
    seg_preds = torch.where(correct, seg_target, torch.randint(0, c_ade, shape, generator=gen, device=dev))
    ade = MulticlassConfusionMatrix(num_classes=c_ade, ignore_index=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    confmat_cuda.launches.reset()
    t0 = time.perf_counter()
    for u in range(n_updates):
        ade.update(seg_preds[u], seg_target[u])
    ade_cm = ade.compute()
    torch.cuda.synchronize()
    ade_s = time.perf_counter() - t0
    ade_launches = int(confmat_cuda.launches)
    ade_peak = torch.cuda.max_memory_allocated()

    ref = torch.zeros((c_ade, c_ade), dtype=torch.int32, device=dev)
    for u in range(n_updates):
        t = seg_target[u].reshape(-1)
        ref += confmat_plain(seg_preds[u].reshape(-1), t, c_ade, t != -1)
    check(torch.equal(ade_cm, ref), "ADE20K confusion matrix != plain version")
    check(int(ade_cm.sum()) == int((~void).sum()), "ADE20K count != number of non-void pixels")
    check(ade_launches == ade.update_count == n_updates, f"confmat launches {ade_launches} != {n_updates} updates")
    pixels = n_updates * maps * side * side
    emit({
        "phase": "ade20k_full", "classes": c_ade, "updates": n_updates, "pixels": pixels,
        "void_share": float(void.float().mean()), "pixel_accuracy": float(ade_cm.diagonal().sum() / ade_cm.sum()),
        "confmat_launches": ade_launches, "seconds": ade_s, "updates_per_s": n_updates / ade_s,
        "pixels_per_s": pixels / ade_s, "peak_mem_bytes": ade_peak,
    })

    # ---------------- ade20k_miou, classification_rest, coco_multilabel, dice_fairness
    miou_launches = phase_ade20k_miou(torch, np, kernel, dev, seg_preds, seg_target, ade_cm, smi)
    rest_launches = phase_classification_rest(torch, np, kernel, dev, logits, target, smi)
    phase_coco_multilabel(torch, np, dev, gen, smi)
    phase_dice_fairness(torch, np, dev, gen, smi)

    # ----------------------------------------------------------------- timing
    shapes = {}
    main_inputs = {
        "imagenet_batch": (_multiclass_confusion_matrix_format(logits[:batch], target[:batch], None), c_in),
        "ade20k_update": (_multiclass_confusion_matrix_format(seg_preds[0], seg_target[0], -1), c_ade),
    }
    for name, ((p, t, valid), c) in main_inputs.items():
        n = p.numel()
        fused = (t * c + p)[valid]
        state = torch.zeros((c, c), dtype=torch.int32, device=dev)
        out = confmat_cuda(p, t, c, valid)
        plain_reps = 20 if n < 100_000 else 5
        label_bytes = n * (2 * p.element_size() + valid.element_size())
        # the main path adds into the metric's state: the labels are read once and only touched cells
        # change; a fresh matrix (the functional API) also zeroes and writes all C * C * 4 bytes
        bound = label_bytes / HBM_BYTES_PER_S * 1e3
        ms = queued_ms(torch, lambda: confmat_cuda(p, t, c, valid, out=state), reps=50)
        shapes[name] = {
            "n": n, "classes": c, "labels": str(p.dtype).split(".")[-1], "weights": "bool mask",
            "ms": ms,
            "call_ms": median_ms(torch, lambda: confmat_cuda(p, t, c, valid, out=state), reps=50),
            "fresh_call_ms": median_ms(torch, lambda: confmat_cuda(p, t, c, valid), reps=50),
            "bound_ms": bound,
            "bound_ms_fresh": (label_bytes + c * c * 4) / HBM_BYTES_PER_S * 1e3,
            "bound_share": bound / ms,
            "zeros_ms": median_ms(torch, lambda: torch.zeros((c, c), dtype=torch.int32, device=dev), reps=50),
            "state_add_ms": median_ms(torch, lambda: state.add_(out), reps=50),
            "plain_ms": median_ms(torch, lambda: confmat_plain(p, t, c, valid), reps=plain_reps, warmup=1),
            "plain_reps": plain_reps,
            "library_ms": median_ms(torch, lambda: torch.bincount(fused, minlength=c * c), reps=50),
            "launches_per_update": 1,
        }
    # one metric call at a time, on the host clock: where a batch's time goes
    p_in, t_in = logits[:batch], target[:batch]
    per_metric = {}
    for label, make in (
        ("imagenet_top1_accuracy", lambda: MulticlassAccuracy(num_classes=c_in, average="micro")),
        ("imagenet_top5_accuracy", lambda: MulticlassAccuracy(num_classes=c_in, average="micro", top_k=5)),
        ("imagenet_confusion_matrix", lambda: MulticlassConfusionMatrix(num_classes=c_in)),
    ):
        metric = make()
        per_metric[label] = {
            "update_ms": wall_ms(torch, lambda m=metric: m.update(p_in, t_in)),
            "forward_ms": wall_ms(torch, lambda m=metric: m(p_in, t_in)),
        }
    metric = MulticlassConfusionMatrix(num_classes=c_ade, ignore_index=-1)
    per_metric["ade20k_confusion_matrix"] = {
        "update_ms": wall_ms(torch, lambda m=metric: m.update(seg_preds[0], seg_target[0])),
    }
    emit({
        "phase": "timing", "shapes": shapes, "wall_ms_per_call": per_metric,
        "ms": "queued_ms, out= the state (device time); call_ms / fresh_call_ms: median_ms, with / without out=",
        "imagenet_val": {"batches_per_s": n_batches / imagenet_s, "samples_per_s": n_val / imagenet_s},
        "ade20k_full": {"updates_per_s": n_updates / ade_s, "pixels_per_s": pixels / ade_s},
        "card": smi,
    })

    phase_confmat_distributions(torch, kernel, dev, gen)

    # ------------------------------------------ image trunks: shapes, kernels
    probe = InceptionFeatureExtractor(feature="2048")  # seeded random weights; shapes only
    calls = inception_conv_calls(probe, torch.zeros((200, 3, 32, 32), dtype=torch.uint8, device=dev))
    check(len(calls) == 94 and sum(map(is_pointwise, calls)) == 40, f"{len(calls)} convs per InceptionV3 forward")
    del probe
    conv_checks = phase_conv_epilogue_vs_plain(torch, ce, calls, dev, gen)
    taps = {net_type: lpips_tap_shapes(torch, dev, net_type, pairs=50, side=256) for net_type in ("alex", "vgg", "squeeze")}
    taps["vgg_ppl"] = lpips_tap_shapes(torch, dev, "vgg", pairs=128, side=64)  # ppl_lpips_vgg's batches
    odd = {"odd": [(3, 5, 7, 35), (2, 9, 9, 5), (7, 3, 3, 1000)], "misaligned": [(4, 15, 15, 384), (2, 31, 31, 64)]}
    head_checks = phase_lpips_head_vs_plain(torch, lh, {**taps, **odd}, dev, gen)

    # ------------------------------------------------------- fid_cifar10_10k
    with tempfile.TemporaryDirectory() as folder:
        fid = phase_fid(torch, np, ce, dev, gen, inception_npz(torch, np, args.seed, folder, dev, gen))
    release_graphs(torch)
    # ----------------------------------------------------------- lpips_pairs
    lpips = phase_lpips(torch, lh, dev, gen)
    release_graphs(torch)
    # ---------------------------------------------------------- image_timing
    image = phase_image_timing(torch, ce, lh, calls, taps["alex"], dev, gen, smi)

    # ------------------------------------------------- text: kernels vs plain
    rng = np.random.default_rng(args.seed)
    # WMT16 newstest2016 de-en: 2,999 pairs; wordpiece lengths 10-100, mean ~40, padded to 128
    wmt = token_corpus(np, rng, pairs=2999, width=128, min_len=10, max_len=100, mean_len=40.0,
                       vocab=BERT_BASE["vocab_size"])
    wmt_mask = torch.as_tensor(wmt[1]["attention_mask"], device=dev)
    att_checks = phase_attention_vs_plain(torch, ka, dev, gen, wmt_mask)
    ln_checks = phase_layernorm_vs_plain(torch, ka, dev, gen, rows=wmt[1]["input_ids"].size)
    # ------------------------------------------- bertscore_wmt, infolm_pairs
    with tempfile.TemporaryDirectory() as folder:
        npz = bert_base_npz(torch, np, args.seed, folder)
        bert = phase_bertscore(torch, np, ka, npz, wmt)
        release_graphs(torch)
        pairs = token_corpus(np, rng, pairs=128, width=64, min_len=10, max_len=64, mean_len=30.0,
                             vocab=BERT_BASE["vocab_size"])
        info = phase_infolm(torch, np, ka, npz, pairs)
    release_graphs(torch)
    # ----------------------------------------------------------- text_timing
    text = phase_text_timing(torch, ka, dev, gen, wmt_mask, smi)

    # ------------------- detection, iou_panoptic, the text metrics without a model
    # the host references run in worker processes while the card works, and are read at the end
    t_detection = time.perf_counter()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        corpora = {"bertscore": wmt, "infolm": pairs}
        text_pending = submit_text_no_model(pool, corpora)
        coco = phase_detection_coco_val(torch, np, dev, gen, pool, smi)
        segm = phase_detection_segm(torch, np, dev, gen, pool)
        emit(phase_detection_stream(torch, dev, gen))
        phase_iou_panoptic(torch, np, dev, gen)
        phase_text_no_model(torch, np, corpora, text_pending)
        finish_detection(coco, segm, t_detection)

    # ----------------------------- the text family without a model, phases 22-27
    text_rng = np.random.default_rng([args.seed, 22])
    text_family(torch, np, dev, gen, smi, kernel_counters(kernel, ce, lh, ka), lambda: {
        "asr": asr_corpus(np, text_rng), "cnndm": cnndm_corpus(np, text_rng), "wmt": wmt_corpus(np, text_rng),
        "squad": squad_corpus(np, text_rng)}, t_main)

    # ------------------------------------------------ the rest of image, phases 28-32
    rest = image_rest(torch, np, ce, lh, dev, gen, args.seed, smi, kernel_counters(kernel, ce, lh, ka), t_main)
    release_graphs(torch)

    # ------------------------------- regression, pairwise and retrieval, phases 33-38
    regression_retrieval(torch, np, dev, torch.Generator(device=dev).manual_seed(args.seed + 33), smi,
                         kernel_counters(kernel, ce, lh, ka), t_main, logits)

    # ------------------------- clustering, nominal association and the wrappers, phases 39-43
    cnw = clustering_nominal_wrappers(torch, np, ce, dev, torch.Generator(device=dev).manual_seed(args.seed + 39),
                                      args.seed, smi, kernel_counters(kernel, ce, lh, ka), t_main, logits, target)
    release_graphs(torch)

    # ------------------------- audio, multimodal and segmentation, phases 44-47
    ams = audio_multimodal_segmentation(torch, np, dev, torch.Generator(device=dev).manual_seed(args.seed + 44),
                                        args.seed, smi, kernel_counters(kernel, ce, lh, ka), t_main, AMS_SIZES)
    release_graphs(torch)

    # --------------------------- the compiled update path, last: it profiles graph replays
    compiled = phase_compiled_path(torch, np, kernel, dev, gen, logits, target, smi)
    release_graphs(torch)
    # ------------- the trunk metrics on the compiled update, the trunks' own graphs, phase 49
    with tempfile.TemporaryDirectory() as folder:
        trunks = phase_captured_trunks(torch, np, ce, lh, ka, kb, dev, torch.Generator(device=dev).manual_seed(args.seed + 49),
                                       args.seed, smi, folder)
        release_graphs(torch)
        # ------------- the runtime telemetry on the compiled path and the FID gauges, phase 50
        observed = phase_observability(torch, np, kernel, ce, dev, torch.Generator(device=dev).manual_seed(args.seed + 50),
                                       logits, target, folder, args.seed, smi)
    release_graphs(torch)
    # ------------- the resilience runtime on the imagenet_val collection, phase 51
    resilient = phase_resilience(torch, np, kernel, dev, logits, target, args.seed, smi)
    release_graphs(torch)
    # ------------- multi-tenant stream pools, B1 across the lanes of each micro-batch, phase 52
    pooled = phase_stream_pool(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 52), smi)
    release_graphs(torch)
    # ------------- the trunk metrics in stream pools, each trunk kernel across the lanes of a micro-batch, phase 53
    with tempfile.TemporaryDirectory() as folder:
        trunk_pools = phase_trunk_pools(torch, np, ce, lh, ka, kb, dev,
                                        torch.Generator(device=dev).manual_seed(args.seed + 53), args.seed, smi, folder)
    release_graphs(torch)
    # ------------- BASELINE config 2's collection through the SPMD engine, B1 and B3 folded over 8 rows, phase 54
    spmd_run = phase_spmd_collection(torch, np, kernel, lh, dev, torch.Generator(device=dev).manual_seed(args.seed + 54),
                                     logits, target, smi)
    release_graphs(torch)
    # ------------- the serving runtime over phase 52's pool, B1 once across each micro-batch's lanes, phase 55
    served = phase_metric_server(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 55), smi)
    release_graphs(torch)
    # ------------- fleet aggregation, 64 edge confusion matrices on the card (B1 an edge update), phase 56
    fleet = phase_fleet_rollup(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 56), smi)
    release_graphs(torch)
    # ------------- the AOT cache: a cold, a warm (no nvcc) and a damaged replica in child processes, phase 57
    aot = phase_aot_cold_start(torch, np, dev, args.seed + 57, smi)
    release_graphs(torch)
    # ------------- the SPMD engine over a world-1 NCCL group, its collectives in each key's graph, phase 58
    spmd_pg = phase_spmd_process_group(torch, np, kernel, lh, dev,
                                       torch.Generator(device=dev).manual_seed(args.seed + 58), logits, target, smi)
    release_graphs(torch)
    # ------------- the port's static analysis: the R1 certificate in Metric, and sanitized runs, phase 59
    analysis = phase_analysis(torch, np, kernel, dev, torch.Generator(device=dev).manual_seed(args.seed + 59), logits,
                              target, smi)
    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "torchmetrics_tpu")],
          "a module of JAX or of the JAX package was imported")

    big = shapes["ade20k_update"]
    image_kernels = [
        ("conv_mm_bias_relu", ":67", fid["launches"]["conv_mm_bias_relu"] + rest["kernel_launches"]["matmul_bias_relu"]
         + cnw["kernel_launches"]["matmul_bias_relu"] + trunks["launches"]["B2a"] + observed["fid_launches"][0],
         conv_checks["worst"]["mm_abs"], "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu",
         "one InceptionV3 forward (40 pointwise convs), batch 200, bf16"),
        ("bias_relu", ":96", fid["launches"]["bias_relu"] + rest["kernel_launches"]["bias_relu_"]
         + cnw["kernel_launches"]["bias_relu_"] + trunks["launches"]["B2b"] + observed["fid_launches"][1],
         conv_checks["worst"]["br_abs"], "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu",
         "one InceptionV3 forward (54 spatial convs), batch 200, bf16; queued_ms: the launches queued ahead of the card"),
        ("lpips_head", ":60", lpips["launches"] + rest["kernel_launches"]["lpips_head"] + trunks["launches"]["B3"],
         head_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/lpips_head.py", "lpips_head.cu",
         "one alex LPIPS forward (5 taps), 50 pairs of 256x256, bf16 maps, queued_ms"),
    ]
    text_at = "one bertscore_wmt encoder forward (2999, 128, 768), 12 heads, float32"
    image_kernels += [
        ("attention", ":57", bert["launches"]["attention"] + info["launches"]["attention"] + trunks["launches"]["B4"],
         att_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/attention.py", "attention.cu", text_at + ": 12 launches"),
        ("layernorm_residual", ":141", bert["launches"]["layernorm_residual"] + info["launches"]["layernorm_residual"]
         + trunks["launches"]["B5"],
         ln_checks["max_abs_err"], "torchmetrics_tpu/_kernels/attention.py", "layernorm_residual.cu", text_at + ": 24 launches"),
    ]
    timings = {**image, **text}
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "confmat",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/confmat.cu",
        "replaces": "torchmetrics_tpu/functional/classification/_pallas_confmat.py:54",
        "launches": imagenet_launches + ade_launches + exact_launches + collection["confmat_launches"]
        + miou_launches + rest_launches + compiled["confmat_launches"] + observed["b1_launches"]
        + resilient["b1_launches"] + pooled["b1_unbatched_launches"] + fleet["b1_launches"] + aot["b1_launches"]
        + analysis["b1_launches"],
        "max_abs_err": max_abs_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": big["library_ms"],
        "bound_ms_fresh": big["bound_ms_fresh"],
        "at": f"ade20k_update: ({big['n']}, {big['classes']}) {big['labels']} labels + bool mask, into the state, "
              "queued_ms; launches include phase 56's fleet edges (512 edge updates, then its chaos, race and store "
              "trees), phase 57's three child processes (a precompile and 3 updates each) and phase 59's eager "
              "config 2 updates (both runs) and sanitized fleet edges",
    }, {
        "name": "confmat_lanes",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/confmat.cu",
        "replaces": "torchmetrics_tpu/functional/classification/_pallas_confmat.py:54",
        "launches": pooled["lanes_launches"] + spmd_run["main"]["lanes_launches"] + served["lanes_launches"]
        + aot["lanes_launches"] + spmd_pg["main"]["lanes_launches"] + analysis["lanes_launches"],
        "max_abs_err": max(pooled["max_abs_err"], spmd_run["timing"]["b1_lanes"]["max_abs_err"],
                           served["lane_check"]["max_abs_err"]),
        "ms": pooled["timing"]["ms"],
        "plain_ms": pooled["timing"]["plain_ms"],
        "bound_ms": pooled["timing"]["bound_ms"],
        "bound_by": pooled["timing"]["bound_by"],
        "library_ms": pooled["timing"]["library_ms"],
        "at": f"one stream_pool micro-batch: ({pooled['lanes']}, {pooled['rows']}) int64 labels + bool mask, "
              f"{pooled['classes']} classes, into the gathered lanes, queued_ms; B1 under torch.func.vmap; launches: "
              "phase 52's micro-batches, phase 54's SPMD steps, phase 55's server micro-batches (with its warm runs), "
              "phase 57's children's pool and engine steps (with their warm_starts), phase 58's steps of the "
              "engine over a process group and phase 59's sanitized server, warm_start and mesh",
        "server_shapes": served["lane_check"]["shapes"],
        "spmd_rows": {k: spmd_run["timing"]["b1_lanes"][k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"torchmetrics_tpu_torch/csrc/{source}",
        "replaces": tpu_file + line,
        "launches": launches,
        "max_abs_err": err,
        "ms": timings[name]["ms"],
        "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"],
        "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"],
        **({"queued_ms": timings[name]["queued_ms"]} if name == "bias_relu" else {}),
        "at": at,
    } for name, line, launches, err, tpu_file, source, at in image_kernels] + [{
        "name": "biquad_bank",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/biquad.cu",
        "replaces": "torchmetrics_tpu/functional/audio/srmr.py:130 (_biquad's lax.scan at :153; no Pallas kernel)",
        "launches": ams["s1"]["launches"] + trunks["launches"]["S1"],
        "max_abs_err": ams["s1"]["max_abs_err"],
        "ms": ams["s1"]["ms"],
        "plain_ms": ams["s1"]["plain_ms"],
        "bound_ms": ams["s1"]["bound_ms"],
        "bound_by": ams["s1"]["bound_by"],
        "library_ms": None,
        "ms_main_path": ams["s1"]["ms_main_path"],
        "bound_ms_main_path": ams["s1"]["bound_ms_main_path"],
        "chain_estimate_ms_main_path": ams["s1"]["chain_estimate_ms_main_path"],
        "at": "one SRMR update's two launches (23 gammatone channels, then their 8 modulation bands) on 2 utterances "
              "of 16,000 samples at 16 kHz, where the plain loop was timed; *_main_path: 16 utterances of 128,000",
    }] + [{
        "name": f"{name}_lanes",
        "route": "cuda",
        "source": f"torchmetrics_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": trunk_pools["launches"][key]
        + (spmd_run["lpips_alex"]["b3_launches"] + spmd_pg["lpips_alex"]["b3_launches"] if key == "B3" else 0),
        "max_abs_err": trunk_pools["kernels"][key]["max_abs_err"],
        "ms": trunk_pools["kernels"][key]["ms"],
        "plain_ms": trunk_pools["kernels"][key]["plain_ms"],
        "bound_ms": trunk_pools["kernels"][key]["bound_ms"],
        "bound_by": trunk_pools["kernels"][key]["bound_by"],
        "library_ms": trunk_pools["kernels"][key]["library_ms"],
        "loop_ms": trunk_pools["kernels"][key]["loop_ms"],
        **({"spmd_rows": {k: spmd_run["timing"]["b3_lanes"][k] for k in ("ms", "plain_ms", "bound_ms")}}
           if key == "B3" else {}),
        "at": f"across lanes, one pooled forward: {at}; ms and loop_ms: queued_ms of the folded launches and of one "
              "launch a lane; the vmap rule of the wrapper's custom op (torchmetrics_tpu_torch/_kernels/lanes.py)"
              + ("; launches: phase 53's pool and phase 54's and phase 58's SPMD steps (8 rows x 8 pairs)"
                 if key == "B3" else ""),
    } for name, key, source, replaces, at in (
        ("conv_mm_bias_relu", "B2a", "conv_epilogue.cu", "torchmetrics_tpu/_kernels/conv_epilogue.py:67",
         "FID 8 lanes x 25 images, 40 launches, bf16"),
        ("bias_relu", "B2b", "conv_epilogue.cu", "torchmetrics_tpu/_kernels/conv_epilogue.py:96",
         "FID 8 lanes x 25 images, 54 launches, bf16"),
        ("lpips_head", "B3", "lpips_head.cu", "torchmetrics_tpu/_kernels/lpips_head.py:60",
         "LPIPS alex 8 lanes x 8 pairs of 256x256, 5 launches, bf16 maps"),
        ("attention", "B4", "attention.cu", "torchmetrics_tpu/_kernels/attention.py:57",
         "ViT-B/16 image tower's shapes, 8 lanes x 8 images, 12 launches, float32; no pooled class launches it "
         "(the CLIP towers' attention is a plain softmax, as in the JAX package), so its main-path launches are 0"),
        ("layernorm_residual", "B5", "layernorm_residual.cu", "torchmetrics_tpu/_kernels/attention.py:141",
         "ViT-B/16 image tower's shapes, 8 lanes x 8 images, 24 launches, float32; no pooled class launches it "
         "(the CLIP towers' LayerNorm is plain, as in the JAX package), so its main-path launches are 0"),
        ("biquad_bank", "S1", "biquad.cu",
         "torchmetrics_tpu/functional/audio/srmr.py:130 (_biquad's lax.scan at :153; no Pallas kernel)",
         "SRMR 8 lanes x 2 utterances of 128,000 samples, 2 launches; plain_ms at 4,000 samples"),
    )]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
