"""Recommender system on movielens (counterpart of
``paddle_tpu/models/recommender.py``, the same programs and parameter
names; reference: tests/book/test_recommender_system.py).

User tower (id/gender/age/job embeddings -> fc) and movie tower (id
embedding + pooled category embeddings + title sequence conv-pool) meet
in cosine similarity scaled to a 5-star rating.
"""

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.dataset import movielens

__all__ = ['build']


def _user_tower(usr, usr_gender, usr_age, usr_job):
    usr_emb = fluid.layers.embedding(
        input=usr, size=[movielens.max_user_id() + 1, 32],
        param_attr=fluid.ParamAttr(name='user_table'))
    usr_fc = fluid.layers.fc(input=usr_emb, size=32)
    gender_emb = fluid.layers.embedding(
        input=usr_gender, size=[2, 16],
        param_attr=fluid.ParamAttr(name='gender_table'))
    gender_fc = fluid.layers.fc(input=gender_emb, size=16)
    age_emb = fluid.layers.embedding(
        input=usr_age, size=[len(movielens.age_table), 16],
        param_attr=fluid.ParamAttr(name='age_table'))
    age_fc = fluid.layers.fc(input=age_emb, size=16)
    job_emb = fluid.layers.embedding(
        input=usr_job, size=[movielens.max_job_id() + 1, 16],
        param_attr=fluid.ParamAttr(name='job_table'))
    job_fc = fluid.layers.fc(input=job_emb, size=16)
    concat = fluid.layers.concat(
        input=[usr_fc, gender_fc, age_fc, job_fc], axis=1)
    return fluid.layers.fc(input=concat, size=200, act='tanh')


def _movie_tower(mov_id, category_id, mov_title_id):
    mov_emb = fluid.layers.embedding(
        input=mov_id, size=[movielens.max_movie_id() + 1, 32],
        param_attr=fluid.ParamAttr(name='movie_table'))
    mov_fc = fluid.layers.fc(input=mov_emb, size=32)
    cat_emb = fluid.layers.embedding(
        input=category_id, size=[movielens.CATEGORY_DICT_SIZE, 32])
    cat_pool = fluid.layers.sequence_pool(input=cat_emb, pool_type='sum')
    title_emb = fluid.layers.embedding(
        input=mov_title_id, size=[movielens.TITLE_DICT_SIZE, 32])
    title_conv = fluid.layers.sequence_conv(
        input=title_emb, num_filters=32, filter_size=3, act='tanh')
    title_pool = fluid.layers.sequence_pool(
        input=title_conv, pool_type='sum')
    concat = fluid.layers.concat(
        input=[mov_fc, cat_pool, title_pool], axis=1)
    return fluid.layers.fc(input=concat, size=200, act='tanh')


def build(lr=0.2):
    feed_names = ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
                  'category_id', 'movie_title', 'score']
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        usr = fluid.layers.data(name='user_id', shape=[1], dtype='int64')
        gender = fluid.layers.data(name='gender_id', shape=[1],
                                   dtype='int64')
        age = fluid.layers.data(name='age_id', shape=[1], dtype='int64')
        job = fluid.layers.data(name='job_id', shape=[1], dtype='int64')
        mov = fluid.layers.data(name='movie_id', shape=[1], dtype='int64')
        cat = fluid.layers.data(name='category_id', shape=[1],
                                dtype='int64', lod_level=1)
        title = fluid.layers.data(name='movie_title', shape=[1],
                                  dtype='int64', lod_level=1)
        score = fluid.layers.data(name='score', shape=[1],
                                  dtype='float32')

        usr_combined = _user_tower(usr, gender, age, job)
        mov_combined = _movie_tower(mov, cat, title)
        similarity = fluid.layers.cos_sim(X=usr_combined, Y=mov_combined)
        scale_infer = fluid.layers.scale(x=similarity, scale=5.0)
        cost = fluid.layers.square_error_cost(input=scale_infer,
                                              label=score)
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=feed_names,
        prediction=scale_infer,
        loss=avg_cost)
